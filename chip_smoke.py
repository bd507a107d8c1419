#!/usr/bin/env python3
"""Drive flowerdiff_torch's sampling and training paths (latent DDPM,
VAE-GAN and the pixel family), its pipeline (the command line, the run
directory and the services built from it) and a reference checkpoint
imported and served over HTTP on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero without a result):
  1. build the CUDA kernels from src/flowerdiff_torch/kernels/csrc;
  2. hold each kernel against its plain PyTorch twin on the card, at the
     flagship shapes of the sampling path (B = 16 and 128 rows: the 8- and
     64-image buckets doubled for classifier-free guidance; and 8, 32 and
     64 rows without it, the buckets phase 17's v1 service runs; the latent
     projection guided and not, with and without the v2 skip; the head in
     the sampler's table form on its column-tile kernel and with the t/c
     products on the whole-row kernel), with LayerNorm affines and biases
     large enough that a kernel leaving any one out would fail, and time
     both, beside each kernel's library yardstick; each stage's launch plan
     printed (clusters, rows and columns a block, ring, shared
     memory) with its tensor-map encodes: at bind, none a launch; then the
     reverse-process kernel (all T steps in one launch) at the guided 8 and
     64 buckets and the unguided 8, 32 and 64, v1 and v2: each bucket's
     plan printed (clusters, blocks, rows a cluster, ring, shared memory,
     waves beside the card's active clusters, encodes at bind), 20 steps
     against the host loop of the step's kernels with every left-out term
     (CFG, the skip, the clip, the noise, a stage's condition add) more than
     twice the limit away, repeats bit-equal, 5 steps against the plain
     twins on the card; the streamed layout forced on the flagship's bound
     plans, bit-equal to the resident one; the same, guided at the 8 and 64
     buckets, at each denoiser of WIDTHS (the --tiny preset's widths, ragged
     widths, six stages, latent 254 with and without the skip, a 2048-wide
     stage, and DEEP_WIDTHS: 63, 340 and 23 stages, a 3456-wide middle,
     latent 2560, a 12-stage v2 net); and a 1000-step call timed at both
     buckets beside the twins' 1000 steps and the bound, at the tiny
     preset's widths and latent 254, and at the 8 bucket at DEEP_WIDTHS;
  3. check the reverse-step noise against the closed-form variance of the
     zero-eps recursion (B = 128, latent 256, T = 1000);
  4. hold the kernel sampler against the plain f32 model on a short
     schedule at flagship width, at both buckets (no step noise, fixed x_init);
  5. profile one guided 50-step sampler call at the 64 bucket as one launch
     of the reverse-process kernel and one through the host loop
     (`fused_sample`, torch.profiler): wall against device time a step, idle
     share, and the kernels that take it;
  6. run SamplingService at flagship width (seeded weights, z-score stats,
     CFG 7.0, x0 clip 3.0, 1000 steps, buckets 8 and 64, uint8 images):
     `warmup` binds each bucket's plan (printed beside the card's active
     clusters); each bucket's full 1000-step stochastic result against the
     host loop's from the same seed within its limit, every left-out term
     more than twice the limit away, repeats bit-equal; the host loop's own
     launches counted over one call; three requests, with the kernel launch
     counts read around them (one launch of the reverse-process kernel a
     bucket call, none of the step's kernels) and checked against one
     profiled bucket call's kernel rows by name; one bucket call timed at
     each bucket (the launch between CUDA events, the whole call by the host
     clock) beside its bound;
     then the decode of one 64 bucket; two identical 50-image requests
     bit-equal as uint8 and as f32 images (the service decodes under
     cuDNN's deterministic algorithms); the decode of 64 latents timed on
     cuDNN's default algorithms, the deterministic ones and in bf16, in
     turns, and the bf16 decode within its limits of the f32 one; then
     SamplingService over the --tiny preset's model as configs.tiny_preset
     makes it (`phase_tiny_service`): warmup, a 70-image uint8 request, one
     launch a bucket call, repeated bit-equal;
  7. serve the same request with `sampler_kind='ddim'` (50 DDIM steps of the
     plain f32 model): latency, the latents against the same DDIM on the
     CPU from one x_init, two identical requests bit-equal;
  8. run `sample_with_trajectory` and `masked_denoise` (per-chain start
     steps) at bucket 8 over 1000 steps: the trajectory ends at x0, a chain
     started at T-1 equals plain `sample` from its x_init;
  9. hold the augmentation (flip, rotation, color jitter) on the card
     against the CPU on injected draws for 64 images, and the card's own
     draws against their closed-form means;
 10. hold the train-step kernel (forward + backward of the latent-DDPM
     objective) against torch autograd on its plain twin at flagship width,
     B = 64, with dropout masks, a condition mask with zeros and perturbed
     biases and LN affines, in both lanes (f32, bf16), with and without the
     v2 skip; check that leaving out any one term would show; time the step;
     count the tensor-map encodes: the binding encodes each map once, a step
     after it none; hold the bf16 step at latent and time embedding 254
     (rows tensor maps cannot read: their products on split-K and mma_dw)
     against its twin at the bf16 limit, v1 and v2; bind the step of a
     40-stage net of 128 (DEEP_TRAIN) in both lanes against its twin;
 11. train the flagship latent DDPM as users run it, on augmented images
     (rotation 10 degrees, jitter 0.2), for 10 epochs (150 steps) on a
     K = 8 pool of cached latents of 1020 synthetic images through
     `LatentDiffusionTrainer.run_epochs_fused`, with the train-step kernel
     and, from the same seed, with eager autograd; compare the loss curves;
     time the pool build with and without augmentation; then sample from
     the EMA weights through the kernel sampler and decode;
 12. train without a cache: 2 epochs of 15 steps of 64, each epoch's 960
     augmented images through one bf16 encoder call, then the bf16
     train-step kernel (`make_fused_latent_epochs` with epoch_encode, via
     the trainer), launches counted; the epoch-encode form against the
     per-step form from one generator in the f32 lane;
 13. drive the whole-epoch train kernel (`make_mega_epoch_fn`: 15 steps of 64
     with draws, forward, backward, clip and AdamW from one library call) at
     flagship width on latents gathered from the augmented K = 8 pool: hold
     an epoch against its plain twin on the same draws from a state 15 steps
     in, in the injected and the stochastic lane, both compute lanes, both
     moment types, with hyperparameters at which the clip, the decay, the
     bias corrections, the falling learning rate and the q/k decay each
     count, and show that a twin epoch without any one of them would fail;
     check the draws' distribution and bit-equal reruns; train 150 steps
     (no tensor-map encode after the first epoch) and sample from the EMA
     weights; time an epoch (wall and busy) beside the per-step kernel body;
     hold an epoch of the 40-stage net against its twin and time it;
 14. train the flagship VAE-GAN (`phase_vae_gan`: channels (64, 128, 256,
     512), latent 256, 102 classes, VGG from the in-repo asset, B = 64, the
     gates of epoch 200 of 1200, so every term is on and the centers update):
     the step on the card against the same step on the CPU at a small width
     from the CPU's draws (3 steps, f32; each leaf of G and D on its own),
     on augmented flower images, and on uniform noise, where only the
     centers are gated, relative to their size (the encoder's rounding
     carried through Adam moves them more than on flowers);
     `VAEGANTrainer.run_epochs_fused` for 2 epochs of 15 augmented batches with the best-state policy in f32
     and in bf16 (finite, the best epoch as the epoch means say, bf16 within
     its band of f32), with every kernel counter read around it (the path
     runs none); two identical 3-step runs bit-equal in each lane; ms a step
     by host clock and CUDA events, cuDNN's deterministic algorithms against
     its default ones in turns, f32, f32 with TF32 and bf16; one profiled
     step, peak memory and the step's bound; then the trained generator,
     through the weight bridge, builds a latent pool and the service decodes
     8 of its latents;
 15. train and serve the pixel family (`phase_pixel`: the v5 PixelUNet at
     the v4/v5 width, base 64, time 128, 64x64x3, T = 1000): the card
     against the CPU at base 16 (the forward; 3 Adam steps with the CPU's
     draws, losses, moments and weights leaf by leaf); in each lane (f32
     with TF32 off, bf16) `PixelDiffusionTrainer.run_epochs_fused` for 2
     epochs of 15 augmented batches of 64 (finite, falling or flat; bf16
     within its band of f32), ms a step by CUDA events over 10 steps, a
     profiled step and the bound from `FlopCounterMode`;
     `PixelSamplingService` at buckets (4, 16, 64): a 64-image request
     timed in each lane beside a sampler step's time, profile and bound, a
     68-image request (chunks 64 and 4), uint8 output equal to the float
     output quantised, two identical requests bit-equal, a 50-step DDIM
     request; every launch counter 0 over the phase; then the full-width
     state saved by `CheckpointManager`, restored bit-equal into a fresh
     state, and one more step from each bit-equal;
 16. run the pipeline as users run it (`phase_runner`), through the
     command line in process (`cli.main`) into a temporary run directory:
     the flagship preset at full width on 1020 synthetic images with the
     train-step kernel, 2 VAE-GAN epochs and 3 latent-DDPM epochs of 15
     steps of 64 (the kernel must launch exactly 45 times, and nothing else
     of the port's kernels); the same command again, which must resume
     (the VAE loaded, the diffusion model at epoch 3, the same recon PSNR);
     `service_from_run` over the directory at guidance 7.0 with uint8
     output: `warmup`, then the 50-image request, with the sampler kernels'
     launches counted (one launch at the 64 bucket), timed, and
     bit-equal when repeated, then `animate`; then a v5 run of 2 epochs and
     `pixel_service_from_run` with one 4-image request; the run
     directories must hold the reference's artifact names; each runner
     stage's wall time is printed from its `[stage ...]` line. Where the
     card has no matplotlib or sklearn, the runs take --no-cadence-viz and
     --no-final-sweep, and the parts of the final sweep that need neither
     (the quality report and the 10 animations) are driven and timed from
     the resumed run's runner;
 17. import a reference user's checkpoint and serve it over HTTP
     (`phase_http`), at preset v1's full width (VAE (64, 128, 256, 512),
     latent 256; denoiser (256, 512, 1024, 512, 256), 102 classes, T =
     1000, z-scored, clip 3.0, no CFG): seeded port modules written in the
     original layout by the exporters (`flower_autoencoder.pt` combined,
     `conditional_diffusion_final.pt`), the import tool's `main` on them
     (every tensor back bit-equal, the discriminator's GroupNorm affines
     through BatchNorm's; the audit counts `IMPORT_COUNTS`); then
     `tools/serve.build_service` over the run directory (uint8), `warmup`
     of its 6 buckets (`serve` refuses the service before it), the v1
     model's kernel sampler against the plain f32 model on a short
     schedule at the buckets the traffic runs (8, 32, 64; no step noise,
     fixed x_init), the device ceiling (one direct 64-row call), and
     `serve` on loopback: /healthz, 16 serial 2-row npy requests (each
     bit-equal to the service called at `derived_seed(seed, k)` for its
     dispatch k), a burst of 16 clients x 4 requests x 2 rows beside one
     /v1/animate (every reply 200 and bit-equal to its dispatch called
     directly, the GIF to `animate`, no plan bound under the traffic, the
     reverse-process kernel launched exactly once a bucket chunk
     dispatched); images/s, dispatches, max_coalesced and latency p50/p99
     printed with the card;
 18. the one-time JPEG ingest (`phase_ingest`): which decoder the card's
     machine has (the port builds the root native/jpeg_loader.cpp with g++
     where libjpeg's headers are there, else PIL, and prints why), 64 JPEGs
     of 500x375 to 64x64 by it and by PIL, timed;
 19. multi-GPU (`phase_parallel`): the flagship VAE-GAN (f32), the uncached
     latent chunk and the v5 pixel chunk, 2 epochs of 2 steps at a global
     batch of 64 on 128 images, with no process group; (a) the same under
     torchrun's environment for one rank on NCCL with the 1x1 mesh, every
     loss and state tensor bit-equal, then `cli.main` at the flagship
     preset with --mesh_data 1 --train_kernel (the train-step kernel
     launches once a step: 8); (b) two spawned ranks on the one card over
     gloo (NCCL refuses two ranks on one device), 32 rows each: the losses
     against world size 1 (tests/test_fused.py's mesh tolerance; the pixel
     family's second epoch as noted at PARALLEL_LOSS_RTOL), the two ranks'
     states bit-equal; (c) in those ranks, the flagship denoiser's forward
     sharded at model=2 against the replicated forward; ms a step of each
     lane beside the step with no group;
 20. print the card's name and power limit, a `kernels` JSON line, and as
     the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import http.client
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(_ROOT / "src"))

from flowerdiff_torch.data import (  # noqa: E402
    DeviceDataset,
    make_augment_fn,
    synthetic_flowers,
)
from flowerdiff_torch.diffusion import linear_schedule  # noqa: E402
from flowerdiff_torch.diffusion.api import (  # noqa: E402
    DDIMSampler,
    DiffusionSampler,
    FusedDiffusionSampler,
    NormalizedSampler,
)
from flowerdiff_torch.kernels import _build  # noqa: E402
from flowerdiff_torch.kernels import train_epoch as te  # noqa: E402
from flowerdiff_torch.kernels import train_step as ts  # noqa: E402
from flowerdiff_torch.kernels.denoiser_apply import (  # noqa: E402
    head_weights,
    stage_weights,
)
from flowerdiff_torch.kernels.full_sampler import (  # noqa: E402
    ReverseProcess,
    bind_latent_proj,
    draw_request,
    fused_sample,
    key_tensor,
    latent_proj,
    latent_proj_plain,
    launch_counts,
    prepare_fused_sampler,
    process_map_encodes,
    process_max_clusters,
    process_smem,
    process_step_us,
    process_widths,
    reverse_process,
    reverse_step,
    reverse_step_plain,
    run_steps,
)
from flowerdiff_torch.kernels.latent_stage import (  # noqa: E402
    LN_EPS,
    bind_head,
    bind_stage,
    chunk_tiles,
    fused_head,
    fused_head_plain,
    fused_stage,
    fused_stage_plain,
    stage_map_encodes,
)
from flowerdiff_torch.serving import PixelSamplingService, SamplingService  # noqa: E402
from flowerdiff_torch.train.checkpoints import (  # noqa: E402
    CheckpointManager,
    state_to_tree,
    tree_into_state,
)
from flowerdiff_torch.train.fused import (  # noqa: E402
    epoch_rows,
    make_fused_cached_epochs,
    make_fused_latent_epochs,
    make_latent_cache_builder,
)
from flowerdiff_torch.train.latent_ddpm import (  # noqa: E402
    LatentDiffusionConfig,
    LatentDiffusionTrainer,
    create_latent_diffusion_state,
)
from flowerdiff_torch.models import VGGPerceptual  # noqa: E402
from flowerdiff_torch.train import pixel_ddpm as px  # noqa: E402
from flowerdiff_torch.train import vae_gan as vg  # noqa: E402
from flowerdiff_torch.train.schedules import vae_gan_loss_gates  # noqa: E402
from flowerdiff_torch.tools.gemm_ab import step_products  # noqa: E402
from flowerdiff_torch.tools.train_gate import (  # noqa: E402
    PRE_LN_BIAS_SCALE,
    left_out_moves,
    moved,
    perturb_module,
)
from flowerdiff_torch.utils.device import derived_generator  # noqa: E402
from flowerdiff_torch.utils.timing import cuda_ms  # noqa: E402
from flowerdiff_torch.utils.weights import (  # noqa: E402
    denoiser_from_params,
    init_numpy_params,
    pixel_unet_from_params,
    residual_stream,
    state_dict_to_flax,
    vae_from_params,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

FLAGSHIP = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256),
                time_emb_dim=256, num_classes=102, shared_cond_proj=True,
                global_skip=False)
VAE = dict(latent_dim=256, channels=(64, 128, 256, 512), head_width=512, base_size=8)
GUIDANCE, CLIP = 7.0, 3.0
ROWS = 128  # a 64-image bucket, doubled for CFG
BUCKET_ROWS = (16, ROWS)  # the rows of the 8 and 64 buckets
# phase_http's v1 service has no CFG, so a bucket call's rows are the
# bucket: the 8, 32 and 64 buckets its requests and its ceiling call run
HTTP_ROWS = (8, 32, 64)
STATS = _ROOT / "artifacts" / "flagship_r5b" / "run" / "latent_stats.npz"
# Kernel vs twin, relative to max|twin|. The twin rounds the same activations
# to bf16, but its f32 sums run in another order, so a value near a rounding
# boundary can land one bf16 ulp away and carry on through later products.
# The readings at the unperturbed flagship weights were 1.4e-3 (stage) and
# 8e-5 (head, with its t/c products) of max|twin|.
STAGE_TOL = 5e-3
HEAD_TOL = 5e-4
NOISE_TOL = 1e-4   # reverse_step vs twin, absolute: same Philox bits, f32 libm
# The reverse-process kernel against the host loop of the step's kernels,
# relative to max|host loop|, by (steps, guided). Never bit-equal: the host
# loop's projection and head sum on other tiles and its stages split the
# columns by their own plans, so a value near a bf16 rounding boundary lands
# one ulp away and the difference carries on through the steps; guided, the
# scale (7.0) multiplies the two branches' difference. 20 steps read
# 1.4e-2 to 1.8e-2 guided, 1.5e-3 to 1.8e-3 unguided; 1000 guided steps at
# the 8 bucket 3.6e-2 (tests/test_torch_port_cuda.py, seeded weights with
# biases of std 0.3). Against the plain twins on the card, 5 steps.
PROCESS_TOL = {(20, True): 3e-2, (20, False): 5e-3, (1000, True): 1e-1, (1000, False): 3e-2,
               (5, True): 3e-2, (5, False): 5e-3}
# latent_proj vs twin, relative to max|twin|: both multiply the same bf16
# values exactly in f32 and add them in another order
PROJ_TOL = 1e-4
# Train-step kernel vs autograd on its twin, per gradient leaf. f32 lane: the
# reference tests' own limits (elementwise). bf16 lane: relative to the
# leaf's largest twin gradient; kernel and twin round the same operands and
# the same dX / dW to bf16, but the kernel's tensor-core products also round
# the incoming gradient to bf16, which the twin keeps in f32, so a rounded
# gradient can land one bf16 ulp away: 2^-9 / 0.25 = 7.8e-3 of the largest
# value at the bottom of its binade, which is the reading. The limit is two
# such ulps.
TRAIN_F32_RTOL, TRAIN_F32_ATOL = 5e-4, 1e-6
TRAIN_BF16_REL = 1.5e-2
TRAIN_BATCH = 64
TRAIN = dict(dropout_rate=0.3, cond_dropout=0.1, ema_decay=0.999, latent_cache=8,
             cache_refresh_epochs=50, normalize_latents=True, lr=1e-3, weight_decay=1e-5,
             grad_clip=1.0, t0=10, t_mult=2, steps_per_epoch=1020 // TRAIN_BATCH,
             encode_dtype="bfloat16", clip_denoised=CLIP, guidance_scale=GUIDANCE)
# bf16-lane kernel run vs the eager f32 run from the same seed: relative
# difference of the per-step losses over the first epoch (the weights drift
# apart by bf16 rounding from the first step on); the reading was 2.7e-4
TRAIN_CURVE_REL = 2e-3
# The epoch kernel vs its twin after one epoch of 15 steps. f32 lane: the
# reference's own limits at this width (tests/test_train_epoch_kernel.py:
# losses rtol 1e-4; weights and first moments rtol 2e-3 / atol 5e-4, the
# absolute part for the few elements whose second moment is near zero, where
# Adam's division amplifies the summation order). q and k take the same f32
# factor on both sides: rtol 1e-6. bf16 lane: losses and moments relative to
# the largest value, as TRAIN_BF16_REL (the moments sum up to 15 gradients
# that are each a bf16 ulp apart, and bf16 storage adds an ulp a step); a
# weight whose gradient is near zero may take Adam's step of size lr in the
# other direction, so one weight may be off by 2 sum(lr) and the limit is on
# a leaf's mean, 5% of sum(lr).
EPOCH_STEPS = 15
EPOCH_LOSS_RTOL = 1e-4
EPOCH_W_RTOL, EPOCH_W_ATOL = 2e-3, 5e-4
EPOCH_NU_ATOL = 1e-7
EPOCH_QK_RTOL = 1e-6
EPOCH_BF16_LOSS_REL = TRAIN_BF16_REL
EPOCH_BF16_MOMENT_REL = 4e-2
EPOCH_BF16_W_MEAN = 0.05
# Hyperparameters at which every term of the optimizer counts (the flagship's
# weight decay of 1e-5 moves a weight by 1e-8 of itself a step, and its clip
# of 1.0 may not bind): a decay of lr wd = 1e-3 a step, a clip far below the
# gradient norm, an SGDR period of one epoch so the rate falls from lr to
# ~0 within the epoch, and a start at step 15, where bc2 = 0.016.
EPOCH_HARD = dict(weight_decay=1.0, grad_clip=0.1, t0=1, t_mult=1, ema_decay=0.9)
# The VAE-GAN of the flagship preset (configs.py:85-86: VAEGANConfig's
# defaults, channels (64, 128, 256, 512), latent 256, head 512, 102
# classes, VGG on), its one-cycle over vae_epochs x 15 steps, batch 64.
VAE_EPOCHS = 1200
VAE_GAN = dict(total_steps=VAE_EPOCHS * 15)
VAE_GAN_BATCH = 64
VAE_GAN_EPOCH = 200  # every gate on, the centers updating
# The card against the CPU, f32 (TF32 off, as main() sets it), 3 steps at a
# small width with the CPU's draws: the limits of the CPU tests against the
# reference (tests/test_torch_port_vae_gan.py): losses rtol 1e-3 (the
# adversarial and D losses move with D's Adam steps on near-rounding
# gradients); the centers within 1e-5; each leaf of G and D on its own: the
# rms of its weights' difference within 5e-2 of the rms of its move from the
# init, and of its Adam first moments' within 2e-2 of their rms. The leaves
# whose gradient is rounding noise in the first steps (the bias of every
# convolution that feeds a LayerNorm2d, which removes it; the channel gates'
# kernels, whose input is a LayerNorm2d's bias, zero at init) are held to
# Adam's bound of 2 lr a step, with a first moment below 1e-6.
VAE_GAN_SMALL = dict(VAE_GAN, channels=(16, 32, 48, 64), latent_dim=32, head_width=64)
VAE_GAN_LOSS_RTOL = 1e-3
VAE_GAN_W_RTOL, VAE_GAN_MU_RTOL, VAE_GAN_NOISE_MU = 5e-2, 2e-2, 1e-6
VAE_GAN_NOISE = re.compile(r"((stem_conv|down\d+_conv|res\d+\.conv[12])\.bias"
                           r"|\.ca\.(squeeze|excite)\.weight)$")
VAE_GAN_CENTER_ATOL = 1e-5
# On uniform noise the centers are held relative to their size: they are an
# EMA of per-class batch means of z, so |dc| / max|c| follows |dz| / max|z|,
# which read up to 1.5e-5 after Adam's first update on the H100 (the weights
# whose gradient is rounding noise step lr either way;
# src/flowerdiff_torch/tools/centers_probe.py, PERF.md section 7). The limit
# is 4e-5 of max|c|.
VAE_GAN_NOISE_CENTER_REL = 4e-5
# bf16 against f32 from one seed (the same data and draws), 2 epochs: the
# relative difference of each loss's epoch mean. The worst reading on the
# H100 was 8.5e-4 (the adversarial term); the band is 1e-2 for every term.
VAE_GAN_BF16_BAND = 1e-2
# The pixel family at the v4/v5 width (PixelDiffusionConfig's defaults: base
# 64, time 128, 64x64x3, T = 1000; the v5 residual on), B = 64 on the 1020
# synthetic images, 15 steps an epoch; served at buckets (4, 16, 64).
PIXEL_BATCH = 64
PIXEL_BUCKETS = (4, 16, 64)
# The card against the CPU at base 16 (time 32), f32 with TF32 off, from one
# seeded tree with nonzero biases: the forward within 1e-5 of max|CPU| (f32
# convolutions summed in another order); 3 Adam steps with the CPU's draws:
# losses rtol 1e-5; each leaf's Adam first moments within VAE_GAN_MU_RTOL of
# their rms; every weight within Adam's bound of 2 lr a step; and, per leaf,
# the weights of the elements whose gradient (the CPU's bias-corrected first
# moment) is at least PIXEL_GRAD_FLOOR of the leaf's rms within
# VAE_GAN_W_RTOL of the leaf's move. At the raw-timestep embedding's scale
# (losses ~1e5 at init) the gradients are heavy-tailed: ~29% of the weights
# have one below 1e-2 of their leaf's rms, and Adam's step, which divides
# each element by its own scale, takes their rounding to up to 4 lr apart
# over 3 steps. On the H100 every element apart by more than lr had a
# gradient below 9.1e-3 of its leaf's rms, and above a floor of 1e-2 the
# rest read 6.8e-3 of the move (PERF.md section 6).
PIXEL_SMALL = dict(base_channels=16, time_emb_dim=32, learnable_residual=True)
PIXEL_FWD_RTOL = 1e-5
PIXEL_LOSS_RTOL = 1e-5
PIXEL_GRAD_FLOOR = 2e-2
# bf16 against f32 from one seed, the same draws, 2 epochs: each epoch mean
# within 5e-2. The losses fall from ~7e6 to ~1e4 over the 30 steps, and the
# two lanes' per-step losses part by up to 6.8% on the way; the worst epoch
# mean read 1.56e-2 on the H100 (the second; the first 2.8e-3).
PIXEL_BF16_BAND = 5e-2


def eager_ms(fn, iters: int = 50) -> float:
    """Wall time of one eager call (launch overhead included), synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_build():
    """Build every library; print each kernel's registers and spills under
    its name (template arguments as <...>)."""
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        entry = "?"
        for line in text.splitlines():
            found = re.search(r"entry function '_ZN?(\w+)'", line)
            if found:
                entry = kernel_name(found.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {entry}: {line.strip()}")


def kernel_name(mangled: str) -> str:
    """The last name of a mangled kernel symbol (the text after _Z or _ZN),
    with its integer template arguments as <...>."""
    rest, name = mangled, mangled
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group(0)
        name, rest = rest[len(digits):len(digits) + int(digits)], rest[len(digits) + int(digits):]
    args = re.findall(r"L[ib](\d+)E", rest) if rest.startswith("I") else []
    return name + (f"<{', '.join(args)}>" if args else "")


def perturbed(weights: dict, gen) -> dict:
    """The kernel operands with LayerNorm scales 1 + 0.2 z and every other f32
    vector 0.5 z, so that leaving any one of them out of a kernel moves its
    output far past the limit (`held` checks this)."""
    out = {}
    for name, w in weights.items():
        if w is None or w.dtype != torch.float32:
            out[name] = w
        else:
            z = torch.randn(w.shape, generator=gen, device=w.device)
            out[name] = 1 + 0.2 * z if name.startswith("g") else 0.5 * z
    return out


def held(what: str, got, ref, rel_tol: float, dropped: dict):
    """Assert |got - ref| <= rel_tol * max|ref|, and that each twin output in
    `dropped` (the twin with one term left out) is more than twice the limit
    away from ref, so that a kernel that left that term out would fail.
    Returns (err, limit, the term whose loss moves the output least)."""
    assert torch.isfinite(got).all(), f"{what}: non-finite output"
    tol = rel_tol * float(ref.abs().max())
    err = max_err(got, ref)
    assert err <= tol, f"{what}: err {err} > {rel_tol} x max|twin| = {tol}"
    moves = {term: max_err(d, ref) for term, d in dropped.items()}
    weakest = min(moves, key=moves.get)
    assert moves[weakest] > 2 * tol, (
        f"{what}: leaving out {weakest} moves the twin only {moves[weakest]}, "
        f"within twice the limit {tol}")
    return err, tol, f"{weakest} {moves[weakest]:.3g}"


def phase_kernels(model, prep, gen):
    """Each kernel against its twin at the main paths' shapes, with
    perturbed LN affines and biases: the guided buckets' row counts
    (BUCKET_ROWS) and the unguided ones of phase_http (HTTP_ROWS: the
    reverse step without CFG, the projection with one copy). The JSON row
    takes the 128-row (guided 64 bucket) times, the worst error over every
    case."""
    dev = torch.device("cuda")
    t = 500
    hidden, lat = FLAGSHIP["hidden_dims"], FLAGSHIP["latent_dim"]
    st = {"name": "fused_stage", "route": "cuda",
          "source": "src/flowerdiff_torch/kernels/csrc/latent_stage.cu",
          "replaces": "src/flowerdiff/kernels/latent_stage.py:45",
          "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "bound_by": "bytes", "library_ms": None}
    hd_row = {"name": "fused_head", "route": "cuda",
              "source": "src/flowerdiff_torch/kernels/csrc/latent_head.cu",
              "replaces": "src/flowerdiff/kernels/latent_stage.py:99",
              "max_abs_err": 0.0, "library_ms": None}
    rv_row = {"name": "reverse_step", "route": "cuda",
              "source": "src/flowerdiff_torch/kernels/csrc/reverse_step.cu",
              "replaces": "src/flowerdiff/kernels/full_sampler.py:81",
              "max_abs_err": 0.0, "library_ms": None}
    pj_row = {"name": "latent_proj", "route": "cuda",
              "source": "src/flowerdiff_torch/kernels/csrc/latent_proj.cu",
              "replaces": "src/flowerdiff/kernels/full_sampler.py:118",
              "max_abs_err": 0.0, "library_ms": None}
    stage_w = [perturbed(stage_weights(model, i), gen) for i in range(len(hidden) - 1)]
    head_w = perturbed(head_weights(model), gen)
    # the projection's inputs from a generator of their own, so that the
    # later phases draw what they drew before it was checked here
    pgen = torch.Generator(device=dev).manual_seed(7)
    cases = [(rows, True) for rows in BUCKET_ROWS] + [(rows, False) for rows in HTTP_ROWS]
    for rows, guided in cases:
        for i, s in enumerate(stage_w):
            d, dout = hidden[i], hidden[i + 1]
            e_bind = stage_map_encodes()
            run = bind_stage(**s)
            e_bind = stage_map_encodes() - e_bind
            plan = run.plan_for(rows)
            sd, so = d // plan.cols, dout // plan.cols
            kbd, kbo = chunk_tiles(sd, d), chunk_tiles(so, d)
            print(f"[kernels] stage plan {d}->{dout} B={rows}: {plan.tiles} cluster(s) of "
                  f"{plan.cols} blocks (column slices), {plan.rows} rows a cluster; a block "
                  f"{sd} columns ({so} of Wd); ring {plan.slots} slots of "
                  f"{max(kbd * sd, kbo * so) * 128} B, a chunk one TMA box of {kbd} k64 tiles "
                  f"({kbd * sd * 128} B; Wd {kbo}, {kbo * so * 128} B); weights read once a "
                  f"cluster; {plan.qbufs} operand buffer(s); smem {plan.smem} B; "
                  f"tensor-map encodes at bind {e_bind}")
            h = torch.randn((rows, d), generator=gen, device=dev)
            tc = torch.randn((rows, d), generator=gen, device=dev) * 0.5
            row = prep["tadds"][i][t]

            def twin(h=h, tc=tc, row=row, **drop):
                w = {**s, **drop}
                return fused_stage_plain(h, tc, **w, row_add=row, eps=LN_EPS)

            ref = twin()
            dropped = {"tc": twin(tc=None), "row_add": twin(row=None)}
            for name in ("bb", "g1", "b1", "g2", "b2", "bv", "bo", "bd"):
                dropped[name] = twin(**{name: (torch.ones_like if name.startswith("g")
                                               else torch.zeros_like)(s[name])})
            e0 = stage_map_encodes()
            err, tol, weakest = held(f"stage {d}->{dout} B={rows}", run(h, tc, row), ref,
                                     STAGE_TOL, dropped)
            ms = cuda_ms(lambda: run(h, tc, row))
            assert stage_map_encodes() == e0, "a bound stage's launch encoded a tensor map"
            plain = cuda_ms(twin)
            eager = eager_ms(lambda: run(h, tc, row))
            n_bytes = (4 * (2 * rows * d + d + 7 * d + dout + rows * dout)
                       + 2 * (3 * d * d + d * dout))
            b_ms, b_by = bound_ms(n_bytes, 2 * rows * d * (3 * d + dout), BF16_FLOP_PER_S)
            print(f"[kernels] fused_stage {d}->{dout} B={rows}: max_abs_err {err:.3e} "
                  f"(tol {tol:.3e}; least move of a left-out term: {weakest}) "
                  f"ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.5f} ({b_by}) "
                  f"eager_ms {eager:.4f}")
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if rows == ROWS:
                st["ms"] += ms
                st["plain_ms"] += plain
                st["bound_ms"] += b_ms
                st["bound_by"] = b_by

        dl = hidden[-1]
        te = FLAGSHIP["time_emb_dim"]
        h = torch.randn((rows, dl), generator=gen, device=dev)
        rows_add = torch.randn((rows, dl), generator=gen, device=dev) * 0.5
        tb = torch.randn((rows, te), generator=gen, device=dev)
        cb = torch.randn((rows, te), generator=gen, device=dev)
        row = prep["tadd_final"][t]
        # the sampler's form: table adds, no products
        w_adds = {**head_w, "wt": None, "bt": None, "wc": None, "bc": None}
        run_adds = bind_head(**w_adds)
        # every input at once: make_fast_denoiser's products and the table adds
        run_all = bind_head(**head_w)

        def htwin(w=head_w, tb=tb, cb=cb, row=row, ra=rows_add, **drop):
            w = {**w, **drop}
            return fused_head_plain(h, tb, cb, **w, row_add=row, rows_add=ra, eps=LN_EPS)

        ref = htwin(w_adds, None, None)
        dropped = {"row_add": htwin(w_adds, None, None, None),
                   "rows_add": htwin(w_adds, None, None, row, None)}
        for name in ("g", "b", "bf"):
            dropped[name] = htwin(w_adds, None, None, **{name: (
                torch.ones_like if name == "g" else torch.zeros_like)(head_w[name])})
        # the table form runs the column-tile kernel, the form with
        # products the whole-row kernel (fused_head.product_launches)
        products = fused_head.product_launches
        err_a, tol_a, weak_a = held(f"head (table adds) B={rows}",
                                    run_adds(h, None, None, row, rows_add), ref,
                                    HEAD_TOL, dropped)
        assert fused_head.product_launches == products, "table form ran the whole-row kernel"
        ref = htwin()
        dropped = {"t_base": htwin(tb=None), "c_base": htwin(cb=None),
                   "bt": htwin(bt=torch.zeros_like(head_w["bt"])),
                   "bc": htwin(bc=torch.zeros_like(head_w["bc"]))}
        err_f, tol_f, weak_f = held(f"head (t, c products) B={rows}",
                                    run_all(h, tb, cb, row, rows_add), ref,
                                    HEAD_TOL, dropped)
        assert fused_head.product_launches == products + 1, "products not on the whole-row kernel"
        ms = cuda_ms(lambda: run_adds(h, None, None, row, rows_add))
        plain = cuda_ms(lambda: htwin(w_adds, None, None))
        eager = eager_ms(lambda: run_adds(h, None, None, row, rows_add))
        ms_f = cuda_ms(lambda: run_all(h, tb, cb, row, rows_add))
        # the yardstick, never on the path: no single PyTorch call computes
        # the head, so two (LayerNorm, then the bf16 product) on bf16 copies
        # of the summed rows; library_ms stays null in the kernels line
        hb = (h + row + rows_add).to(torch.bfloat16)
        gb, bb, bfb = (head_w[n].to(torch.bfloat16) for n in ("g", "b", "bf"))
        two_calls = cuda_ms(lambda: torch.addmm(bfb, torch.nn.functional.layer_norm(
            hb, (dl,), gb, bb, LN_EPS), head_w["wf"].t()))
        n_bytes = 4 * (2 * rows * dl + 3 * dl + lat + rows * lat) + 2 * dl * lat
        b_ms, b_by = bound_ms(n_bytes, 2 * rows * dl * lat, BF16_FLOP_PER_S)
        print(f"[kernels] fused_head {dl}->{lat} B={rows}: max_abs_err {err_a:.3e} "
              f"(tol {tol_a:.3e}; least move: {weak_a}), with t/c products {err_f:.3e} "
              f"(tol {tol_f:.3e}; least move: {weak_f}) ms {ms:.4f} plain_ms {plain:.4f} "
              f"bound_ms {b_ms:.5f} ({b_by}) eager_ms {eager:.4f}; with t/c products "
              f"(whole-row kernel) ms {ms_f:.4f}")
        print(f"[kernels] fused_head yardstick B={rows}: two calls, F.layer_norm then bf16 "
              f"torch.addmm, on bf16 copies of the summed rows: ms {two_calls:.4f}")
        hd_row["max_abs_err"] = max(hd_row["max_abs_err"], err_a, err_f)
        if rows == ROWS:
            hd_row.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)

        b = rows // 2 if guided else rows
        eps = torch.randn((rows, lat), generator=gen, device=dev)
        x = torch.randn((b, lat), generator=gen, device=dev)
        kw = dict(guidance_scale=GUIDANCE if guided else None, clip_x0=CLIP, stochastic=True,
                  key=(12345, 678))
        # the key as the sampler passes it: two words in device memory
        dev_kw = dict(kw, key=key_tensor(kw["key"], dev))
        coefs = prep["coefs"][t]
        got = reverse_step(eps, x, t, coefs, **kw)
        err = max_err(got, reverse_step_plain(eps, x, t, coefs, **kw))
        assert err <= NOISE_TOL, f"reverse_step B={b}: err {err} > {NOISE_TOL}"
        assert torch.equal(reverse_step(eps, x, t, coefs, **dev_kw), got), (
            f"reverse_step B={b}: the key in device memory draws other noise than the ints")
        ms = cuda_ms(lambda: reverse_step(eps, x, t, coefs, **dev_kw))
        plain = cuda_ms(lambda: reverse_step_plain(eps, x, t, coefs, **kw))
        eager = eager_ms(lambda: reverse_step(eps, x, t, coefs, **dev_kw))
        b_ms, b_by = bound_ms(4 * (rows * lat + 2 * b * lat), 60 * b * lat, F32_FLOP_PER_S)
        print(f"[kernels] reverse_step B={b} (eps {rows} rows, CFG {guided}): max_abs_err "
              f"{err:.3e} (tol {NOISE_TOL:.0e}) ms {ms:.4f} plain_ms {plain:.4f} "
              f"bound_ms {b_ms:.5f} ({b_by}) eager_ms {eager:.4f}")
        rv_row["max_abs_err"] = max(rv_row["max_abs_err"], err)
        if rows == ROWS:
            rv_row.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)

        # the step's projection: guided (both halves of the stage input) and
        # not, with and without the v2 skip (the flagship is v1: no skip);
        # unguided only at phase_http's rows
        hid = hidden[0]
        wl = prep["proj"].weights[0]
        bl = torch.randn((hid,), generator=pgen, device=dev) * 0.5
        skip_w = dict(wf=head_w["wf"], bf=torch.randn((lat,), generator=pgen, device=dev) * 0.5,
                      rw=torch.tensor(0.3, device=dev))
        skip_rw_dropped = dict(skip_w, rw=torch.tensor(30.0, device=dev))  # sigmoid -> 1
        for proj_guided in ((True, False) if guided else (False,)):
            copies = 2 if proj_guided else 1
            b = rows // copies
            x = torch.randn((b, lat), generator=pgen, device=dev)
            for with_skip in (False, True):
                kw = skip_w if with_skip else {}
                run = bind_latent_proj(wl, bl, **kw)
                h, skip = run(x, copies)
                ref_h, ref_skip = latent_proj_plain(x, wl, bl, copies=copies, **kw)
                tag = f"B={b} rows {rows} guided={proj_guided} skip={with_skip}"
                if proj_guided:
                    assert torch.equal(h[:b], h[b:]), f"latent_proj {tag}: the two copies differ"
                dropped = {"bl": latent_proj_plain(x, wl, torch.zeros_like(bl),
                                                   copies=copies)[0]}
                err, tol, weakest = held(f"latent_proj h {tag}", h, ref_h, PROJ_TOL, dropped)
                pj_row["max_abs_err"] = max(pj_row["max_abs_err"], err)
                line = (f"[kernels] latent_proj {tag}: h max_abs_err {err:.3e} (tol {tol:.3e}; "
                        f"least move: {weakest})")
                if with_skip:
                    dropped = {"bf": latent_proj_plain(x, wl, bl, copies=copies, **dict(
                                   skip_w, bf=torch.zeros_like(skip_w["bf"])))[1],
                               "sigmoid(rw)": latent_proj_plain(x, wl, bl, copies=copies,
                                                                **skip_rw_dropped)[1]}
                    err, tol, weakest = held(f"latent_proj skip {tag}", skip, ref_skip,
                                             PROJ_TOL, dropped)
                    pj_row["max_abs_err"] = max(pj_row["max_abs_err"], err)
                    line += f"; skip max_abs_err {err:.3e} (tol {tol:.3e}; least move: {weakest})"
                ms = cuda_ms(lambda: run(x, copies))
                plain = cuda_ms(lambda: latent_proj_plain(x, wl, bl, copies=copies, **kw))
                n_bytes = 4 * (b * lat + hid + copies * b * hid) + 2 * hid * lat
                flops = 2 * b * lat * hid
                if with_skip:
                    n_bytes += 2 * lat * lat + 4 * (lat + 1 + b * lat)
                    flops += 2 * b * lat * lat
                b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
                wl32 = wl.float()
                addmm = cuda_ms(lambda: torch.addmm(bl, x, wl32.t()))
                # the library yardstick, never on the path: h's product on
                # bf16 copies of the operands, one copy (the least work of
                # the function), and both copies in one batched call
                xb, blb = x.to(torch.bfloat16), bl.to(torch.bfloat16)
                lib = cuda_ms(lambda: torch.addmm(blb, xb, wl.t()))
                lib2 = cuda_ms(lambda: torch.baddbmm(blb, xb.expand(copies, b, lat),
                                                     wl.t().expand(copies, lat, hid)))
                print(f"{line} ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.5f} ({b_by}) "
                      f"library_ms {lib:.4f} (bf16 torch.addmm, one copy of h, no skip; "
                      f"{copies} copies by torch.baddbmm {lib2:.4f}); the replaced eager "
                      f"torch.addmm (f32, one copy, no skip) {addmm:.4f}")
                if rows == ROWS and guided and proj_guided and not with_skip:
                    pj_row.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib)
    return [st, hd_row, rv_row, pj_row]


def plain_steps(prep, inputs, *, stochastic=True, clip_x0=None, guidance_scale=None):
    """The T steps on the kernels' plain twins (PyTorch ops on the card's
    tensors): the reverse-process kernel's plain version, step for step as
    `run_steps` issues the kernels."""
    wl, bl, wf, bf, rw = prep["proj"].weights
    _, _, _, _, g, b, hwf, hbf = prep["head"].weights
    copies = 2 if guidance_scale is not None else 1
    x = inputs.x
    for t in range(prep["n_steps"] - 1, -1, -1):
        h, skip = latent_proj_plain(x, wl, bl, copies=copies, wf=wf, bf=bf, rw=rw)
        for i, stage in enumerate(prep["stages"]):
            h = fused_stage_plain(h, inputs.stage_adds[i], *stage.weights,
                                  row_add=prep["tadds"][i][t], eps=LN_EPS)
        eps = fused_head_plain(h, None, None, None, None, None, None, g, b, hwf, hbf,
                               row_add=prep["tadd_final"][t], rows_add=inputs.final_add,
                               eps=LN_EPS)
        x = reverse_step_plain(eps, x, t, prep["coefs"][t], guidance_scale=guidance_scale,
                               clip_x0=clip_x0, stochastic=stochastic, key=inputs.key, skip=skip)
    return x


def left_out(prep, inputs, kw):
    """The host loop with one term of the process left out at a time (the
    condition add of stage 2, or of the last stage where there are fewer, or
    more than 8: deep in the chain one stage's add washes out)."""
    adds = list(inputs.stage_adds)
    i = min(2, len(adds) - 1) if len(adds) <= 8 else len(adds) - 1
    adds[i] = torch.zeros_like(adds[i])
    out = {"noise": run_steps(prep, inputs, **dict(kw, stochastic=False)),
           f"stage {i}'s condition add": run_steps(prep, inputs._replace(stage_adds=tuple(adds)),
                                                   **kw)}
    if kw["guidance_scale"] is not None:  # the clip binds under CFG 7.0
        out["CFG"] = run_steps(prep, inputs, **dict(kw, guidance_scale=1.0))
        out["clip"] = run_steps(prep, inputs, **dict(kw, clip_x0=None))
    if prep["model"].global_skip:
        wl, bl = prep["proj"].weights[:2]
        out["skip"] = run_steps(dict(prep, proj=bind_latent_proj(wl, bl)), inputs, **kw)
    return out


# Denoisers the JAX package samples with its kernel, which the port's card
# path takes (any width up to 4096, any depth): (name, latent, hidden, v2
# skip). A stage's input width is a multiple of its 8 attention heads, so
# latent 254 takes the skip with a last width of 254. DEEP_WIDTHS: past the
# resident layout's 8 stages or 2048 wide, at the JAX kernel's edge (its
# 100 MiB at the 64 bucket), each also timed at 1000 steps.
DEEP_WIDTHS = [("63 stages of 256", 256, (256,) * 64, False),
               ("340 stages of 64", 64, (64,) * 341, False),
               ("23 stages of 512", 512, (512,) * 24, False),
               ("3456-wide middle", 256, (256, 512, 3456, 512, 256), False),
               ("latent 2560", 2560, (2560, 2560), False),
               ("12 stages, skip", 64, (64,) * 13, True)]
WIDTHS = [("tiny preset", 32, (32, 64, 32), False),
          ("ragged", 96, (96, 200, 96), False),
          ("six stages", 64, (64, 128, 128, 128, 128, 128, 64), False),
          ("latent 254", 254, (256, 512, 1024, 512, 256), False),
          ("latent 254, skip", 254, (256, 512, 1024, 512, 254), True),
          ("2048-wide stage", 256, (256, 2048, 256), False)] + DEEP_WIDTHS


# Lopsided denoisers the JAX kernel holds past 4096, beside narrow stages:
# a last hidden width and a latent at its edge at the 8 bucket (25,706 and
# 1,047,802; tests/test_torch_port_wide.py), the flagship's hidden widths
# under a 16,384-wide latent (a 4x64x64 latent, flattened), a v2 net at 5120.
# The reverse-process kernel runs them on its wide layout; its host loop,
# the oracle, runs the stage, head and projection kernels in their passes.
# (name, latent, hidden, v2 skip, the buckets the JAX kernel holds it at
# that are sampled here)
WIDE = [("last width 25706", 8, (8, 8, 25706), False, (8,)),
        ("latent 1047802", 1047802, (8, 8), False, (8,)),
        ("latent 16384", 16384, FLAGSHIP["hidden_dims"], False, (8, 64)),
        ("v2 latent 5120", 5120, (256, 512, 5120), True, (8, 64))]
# The product-form head past 2048 (make_fast_denoiser's): (rows, d_last,
# d_emb, latent)
WIDE_HEADS = [(16, 2112, 2080, 2056), (128, 4500, 256, 256), (16, 256, 256, 16384)]
# The host loop's kernels at the WIDE nets' shapes, guided at the 8 bucket:
# the stages (rows, d, d_out) whose Wd runs in passes, the head's table form
# (rows, d_last, latent) with K in passes or a 16384-wide output, the
# projection (samples, latent, hidden[0]) with L past 4096
WIDE_STAGES = [(16, 8, 25706), (16, 512, 5120)]
WIDE_TABLE_HEADS = [(16, 25706, 8), (16, 256, 16384), (16, 5120, 5120)]
WIDE_PROJECTIONS = [(8, 1047802, 8), (8, 16384, 256)]


def width_model(latent, hidden, skip, seed=3):
    """A seeded denoiser of the given widths (biases of std 0.3, so that each
    condition add moves the result), 102 classes, on the card; past 8 stages
    a residual stream (`residual_stream`: the plain seeded tree is chaotic
    there, a bf16 rounding landing the other way moves a guided sample past
    PROCESS_TOL, and at 340 stages it overflows)."""
    kw = dict(latent_dim=latent, hidden_dims=hidden, time_emb_dim=32 if latent == 32 else 64,
              num_classes=FLAGSHIP["num_classes"], shared_cond_proj=True, global_skip=skip)
    tree = init_numpy_params("denoiser", seed=seed, bias_std=0.3, **kw)
    if len(hidden) > 9:
        residual_stream(tree)
    return denoiser_from_params(tree, device="cuda", **kw)


def process_case(prep, process, b, guided, steps, gen, tag, dev):
    """One bucket call of the reverse-process kernel: repeats bit-equal, no
    encode a launch, against the host loop with its left-out terms (20
    steps) or the plain twins (5 steps). Returns (err, tol, weakest, what)."""
    kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE if guided else None)
    cls = torch.arange(b, device=dev) % FLAGSHIP["num_classes"]
    inputs = draw_request(prep, b, cls, None, gen, None, guided)
    process.plan_for(b, guided)
    e0 = process_map_encodes()
    got = process(inputs, **kw)
    assert torch.equal(process(inputs, **kw), got), f"{tag}: repeats differ"
    assert process_map_encodes() == e0, "a bound plan's launch encoded a tensor map"
    if steps == 20:
        ref, what = run_steps(prep, inputs, **kw), "host loop"
        dropped = left_out(prep, inputs, kw)
    else:
        ref, what, dropped = plain_steps(prep, inputs, **kw), "twins", {}
    tol_rel = PROCESS_TOL[(steps, guided)]
    if dropped:
        err, tol, weakest = held(tag, got, ref, tol_rel, dropped)
    else:
        err = max_err(got, ref)
        tol, weakest = tol_rel * float(ref.abs().max()), "-"
        assert torch.isfinite(got).all() and err <= tol, (tag, err, tol)
    return err, tol, weakest, what


def print_plan(tag, plan, b, guided, e_bind):
    active = process_max_clusters(plan)
    print(f"[kernels] {tag} plan B={b} guided={guided} ({b * (2 if guided else 1)} rows): "
          f"{plan.clusters} cluster(s) of {plan.cols} blocks, {plan.rows} rows a cluster, "
          f"{plan.qbufs} operand buffer(s), ring {plan.slots} slots, smem {plan.smem} B, "
          f"{plan.waves} wave(s) (the card runs {active} such clusters at once); "
          f"tensor-map encodes at bind {e_bind}")
    assert plan.waves > 1 or plan.clusters <= active, (plan, active)


def streamed_bit_equal(prep, process, skip, dev):
    """The streamed layout (maps, widths and time tables in device memory,
    vectors and condition rows read from L2), forced at the bound plan's
    geometry of the flagship's guided buckets: the same bits as the
    resident launch. Its requests draw from a generator of their own."""
    model = prep["model"]
    gen = torch.Generator(device=dev).manual_seed(21)
    for b in (8, 64):
        plan = process.plan_for(b, True)
        lat_p, hid_p = process_widths(model.latent_dim, model.hidden_dims, plan.cols)
        streamed = plan._replace(streamed=True, smem=process_smem(
            lat_p, hid_p, skip, plan.cols, plan.rows, plan.qbufs, plan.slots, True))
        inputs = draw_request(prep, b, torch.arange(b, device=dev) % FLAGSHIP["num_classes"],
                              None, gen, None, True)
        kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE)
        same = torch.equal(process(inputs, plan=streamed, **kw), process(inputs, **kw))
        print(f"[kernels] reverse_process skip={skip} B={b}: the streamed layout at the bound "
              f"plan's geometry bit-equal to the resident one: {same}")
        assert same, f"streamed and resident layouts differ at B={b} skip={skip}"


def phase_process(prep, gen):
    """The reverse-process kernel (csrc/reverse_process.cu) at every bucket
    the services launch here: the guided 8 and 64 (16 and 128 rows),
    phase_http's unguided 8, 32 and 64, and the ladder's unguided 256 and
    guided 128 (11 clusters of 24 rows, one wave, the last cluster ragged),
    v1 and v2: each bucket's plan printed (clusters, blocks, rows, ring,
    shared memory, waves, the card's active clusters, the tensor-map
    encodes of its binding); 20 steps against the host loop of the step's
    kernels (`run_steps`) within PROCESS_TOL with every left-out term more
    than twice the limit away, a repeat bit-equal, no encode a launch; 5
    steps against the plain twins on the card. The same at each denoiser of WIDTHS, guided, at the 8 and 64
    buckets. Then a 1000-step guided call at both buckets timed between
    CUDA events beside the twins' 1000 steps at the 64 bucket and the
    bound, and at the tiny preset's widths and latent 254. The JSON row's
    error is the worst over every case."""
    dev = torch.device("cuda")
    row = {"name": "reverse_process", "route": "cuda",
           "source": "src/flowerdiff_torch/kernels/csrc/reverse_process.cu",
           "replaces": "src/flowerdiff/kernels/full_sampler.py:81", "max_abs_err": 0.0,
           "library_ms": None}
    cases = [(8, True), (64, True), (8, False), (32, False), (64, False), (256, False),
             (128, True)]
    # the 24-row buckets draw from a generator of their own, so the later
    # cases and phases draw what they drew before them
    one_wave_gen = torch.Generator(device=dev).manual_seed(25)
    for skip in (False, True):
        # biases of std 0.3, so that each condition add moves the result
        kw_model = dict(FLAGSHIP, global_skip=skip)
        mdl = denoiser_from_params(init_numpy_params("denoiser", seed=3, bias_std=0.3,
                                                     **kw_model), device=dev, **kw_model)
        for steps in (20, 5):
            p = prepare_fused_sampler(mdl, linear_schedule(steps))
            process = ReverseProcess(p)
            for b, guided in cases:
                e0 = process_map_encodes()
                plan = process.plan_for(b, guided)
                if steps == 20 and not skip:
                    print_plan("reverse_process", plan, b, guided, process_map_encodes() - e0)
                tag = f"reverse_process B={b} guided={guided} skip={skip} T={steps}"
                g = one_wave_gen if b * (2 if guided else 1) == 256 else gen
                err, tol, weakest, what = process_case(p, process, b, guided, steps, g, tag, dev)
                print(f"[kernels] {tag} against the {what}: max_abs_err {err:.3e} (tol "
                      f"{tol:.3e}; least move of a left-out term: {weakest}); repeat bit-equal")
                row["max_abs_err"] = max(row["max_abs_err"], err)
            if steps == 20:
                streamed_bit_equal(p, process, skip, dev)
    # every width and depth: the bound plans, 20 steps against the host loop
    # with the left-out terms, 5 against the twins
    widths_err = 0.0
    # the nets past 8 stages or 2048 draw from a generator of their own, so
    # the later phases draw what they drew before them
    deep_gen = torch.Generator(device=dev).manual_seed(20)
    for name, lat, hidden, skip in WIDTHS:
        mdl = width_model(lat, hidden, skip)
        g = deep_gen if (name, lat, hidden, skip) in DEEP_WIDTHS else gen
        for steps in (20, 5):
            p = prepare_fused_sampler(mdl, linear_schedule(steps))
            process = ReverseProcess(p)
            for b in (8, 64):
                e0 = process_map_encodes()
                plan = process.plan_for(b, True)
                tag = f"reverse_process {name} (latent {lat}, hidden {hidden}) B={b} T={steps}"
                if steps == 20:
                    print_plan(f"reverse_process {name}", plan, b, True,
                               process_map_encodes() - e0)
                err, tol, weakest, what = process_case(p, process, b, True, steps, g, tag, dev)
                print(f"[kernels] {tag} against the {what}: max_abs_err {err:.3e} (tol "
                      f"{tol:.3e}; least move of a left-out term: {weakest}); repeat bit-equal")
                widths_err = max(widths_err, err)
    row["max_abs_err"] = max(row["max_abs_err"], widths_err)
    row["max_abs_err_widths"] = widths_err
    # the 1000-step calls: the kernel at both buckets, the twins at 64
    for b in (8, 64):
        inputs = draw_request(prep, b, torch.arange(b, device=dev) % FLAGSHIP["num_classes"],
                              None, gen, None, True)
        kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE)
        process = ReverseProcess(prep)
        process(inputs, **kw)
        ms = [event_ms(lambda: process(inputs, **kw), 1) for _ in range(3)]
        b_ms, b_by = sampler_bound_ms(prep, b)
        line = (f"[kernels] reverse_process B={b} guided, 1000 steps: ms {np.mean(ms):.3f} "
                f"(runs {[round(v, 3) for v in ms]}) bound_ms {b_ms:.4f} ({b_by})")
        if b == 64:
            plain = event_ms(lambda: plain_steps(prep, inputs, **kw), 1)
            row.update(ms=float(np.mean(ms)), plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
            line += f" plain_ms {plain:.3f} (the twins' 1000 steps on the card)"
        else:
            row["ms_bucket_8"] = float(np.mean(ms))
        print(line)
        # the streamed layout forced at the bound plan's geometry, in turns
        # with the resident one: what the flagship's resident layout buys
        plan = process.plan_for(b, True)
        lat_p, hid_p = process_widths(prep["model"].latent_dim, prep["model"].hidden_dims,
                                      plan.cols)
        streamed = plan._replace(streamed=True, smem=process_smem(
            lat_p, hid_p, False, plan.cols, plan.rows, plan.qbufs, plan.slots, True))
        process(inputs, plan=streamed, **kw)
        turns = {"resident": [], "streamed": []}
        for kind in ("resident", "streamed", "streamed", "resident") * 2:
            turns[kind].append(event_ms(lambda: process(
                inputs, plan=streamed if kind == "streamed" else None, **kw), 1))
        res, stm = (float(np.mean(turns[k])) for k in ("resident", "streamed"))
        print(f"[kernels] reverse_process B={b} guided, 1000 steps, in turns: resident "
              f"{res:.3f} ms {[round(v, 3) for v in turns['resident']]}, streamed forced "
              f"{stm:.3f} ms {[round(v, 3) for v in turns['streamed']]} "
              f"({100 * (stm / res - 1):+.2f}%)")
        row[f"ms_in_turns_bucket_{b}"] = {"resident": res, "streamed": stm}
    # the same 1000-step calls at the tiny preset's widths and at latent 254
    sched = linear_schedule(1000)
    for name, lat, hidden, skip in (WIDTHS[0], WIDTHS[3]):
        p = prepare_fused_sampler(width_model(lat, hidden, skip), sched.to("cuda"))
        process = ReverseProcess(p)
        for b in (8, 64):
            inputs = draw_request(p, b, torch.arange(b, device=dev) % FLAGSHIP["num_classes"],
                                  None, gen, None, True)
            kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE)
            process(inputs, **kw)
            ms = [event_ms(lambda: process(inputs, **kw), 1) for _ in range(3)]
            b_ms, b_by = sampler_bound_ms(p, b)
            print(f"[kernels] reverse_process {name} (latent {lat}, hidden {hidden}) B={b} "
                  f"guided, 1000 steps: ms {np.mean(ms):.3f} (runs {[round(v, 3) for v in ms]}) "
                  f"bound_ms {b_ms:.4f} ({b_by}); plan {process.plan_for(b, True)}")
            row[f"ms_{name.replace(' ', '_')}_bucket_{b}"] = float(np.mean(ms))
    # one 1000-step guided call at the 8 bucket of each net past 8 stages or 2048
    for name, lat, hidden, skip in DEEP_WIDTHS:
        p = prepare_fused_sampler(width_model(lat, hidden, skip), sched.to("cuda"))
        process = ReverseProcess(p)
        inputs = draw_request(p, 8, torch.arange(8, device=dev) % FLAGSHIP["num_classes"],
                              None, deep_gen, None, True)
        kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE)
        got = process(inputs, **kw)  # binds, and warms up
        assert torch.isfinite(got).all(), name
        ms = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            process(inputs, **kw)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        b_ms, b_by = sampler_bound_ms(p, 8)
        plan = process.plan_for(8, True)
        print(f"[kernels] reverse_process {name} (latent {lat}, {len(hidden) - 1} stages, "
              f"widest {max(hidden)}) B=8 guided, 1000 steps: ms {np.mean(ms):.3f} (runs "
              f"{[round(v, 3) for v in ms]}) bound_ms {b_ms:.4f} ({b_by}); plan {plan}")
        row[f"ms_{name.replace(' ', '_').replace(',', '')}_bucket_8"] = float(np.mean(ms))
        del p, process
    return row


def phase_wide():
    """The lopsided nets of WIDE on the reverse-process kernel's wide layout,
    guided, at their buckets: each bucket's plan printed; 20 steps against
    the host loop (whose stage, head and projection kernels run their
    passes past 4096) within PROCESS_TOL with every left-out term more than
    twice the limit away, 5 against the plain twins on the card; repeats
    bit-equal; the launch counts of each run read from zero (kernel 3 once a
    call; the host loop's kernels each launched). Then one 1000-step call at
    the 8 bucket timed between CUDA events beside its bound and the cost
    model's figure, its counts from zero (one launch, nothing else). Then
    the host loop's kernels at the nets' shapes (WIDE_STAGES,
    WIDE_TABLE_HEADS, WIDE_PROJECTIONS) and the product-form head past 2048
    (WIDE_HEADS), each against its twin with its left-out terms, timed
    beside its bound. Returns the numbers for the kernels line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)  # the later phases draw what they drew
    out = {name: {"max_abs_err": 0.0}
           for name in ("reverse_process", "fused_stage", "fused_head", "latent_proj")}
    out["launches"] = dict.fromkeys(launch_counts(), 0)
    kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE)
    for name, lat, hidden, skip, buckets in WIDE:
        mdl = width_model(lat, hidden, skip)
        for steps in (20, 5):
            p = prepare_fused_sampler(mdl, linear_schedule(steps))
            process = ReverseProcess(p)
            for b in buckets:
                e0 = process_map_encodes()
                plan = process.plan_for(b, True)
                assert plan.wide, (name, plan)
                if steps == 20:
                    print_plan(f"reverse_process {name}", plan, b, True,
                               process_map_encodes() - e0)
                tag = f"reverse_process {name} (latent {lat}, hidden {hidden}) B={b} T={steps}"
                reset_counts()
                err, tol, weakest, what = process_case(p, process, b, True, steps, gen, tag, dev)
                counts = launch_counts()
                assert counts["reverse_process"] == 2, (tag, counts)  # the call and its repeat
                host = {k: counts[k] for k in ("latent_proj", "fused_stage", "fused_head",
                                               "reverse_step")}
                assert all(host.values()) if steps == 20 else not any(host.values()), (tag, counts)
                for k, v in counts.items():
                    out["launches"][k] += v
                print(f"[wide] {tag} against the {what}: max_abs_err {err:.3e} (tol {tol:.3e}; "
                      f"least move of a left-out term: {weakest}); repeat bit-equal; launches "
                      f"from zero {counts}")
                out["reverse_process"]["max_abs_err"] = max(
                    out["reverse_process"]["max_abs_err"], err)
        # one 1000-step guided call at the 8 bucket, timed
        p = prepare_fused_sampler(mdl, linear_schedule(1000).to("cuda"))
        process = ReverseProcess(p)
        inputs = draw_request(p, 8, torch.arange(8, device=dev) % FLAGSHIP["num_classes"],
                              None, gen, None, True)
        plan = process.plan_for(8, True)
        reset_counts()
        got = process(inputs, **kw)
        counts = launch_counts()
        assert counts == dict(dict.fromkeys(counts, 0), reverse_process=1), (name, counts)
        assert torch.isfinite(got).all() and got.shape == (8, lat), name
        assert torch.equal(process(inputs, **kw), got), f"{name}: 1000-step repeats differ"
        ms = [event_ms(lambda: process(inputs, **kw), 1) for _ in range(2)]
        b_ms, b_by = sampler_bound_ms(p, 8)
        model_ms = process_step_us(lat, hidden, skip, plan) * plan.waves
        print(f"[wide] reverse_process {name} (latent {lat}, hidden {hidden}, skip {skip}) B=8 "
              f"guided, 1000 steps: ms {np.mean(ms):.3f} (runs {[round(v, 3) for v in ms]}) "
              f"bound_ms {b_ms:.4f} ({b_by}); the cost model's {model_ms:.1f} ms; plan {plan}")
        out["reverse_process"][f"ms_{name.replace(' ', '_')}_bucket_8"] = float(np.mean(ms))
        out["reverse_process"][f"bound_ms_{name.replace(' ', '_')}_bucket_8"] = b_ms
        del p, process, mdl, inputs, got
        torch.cuda.empty_cache()
    def r(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # the host loop's own kernels at the wide nets' shapes, each against its
    # twin with its left-out terms, timed beside its bound: the stage with
    # Wd in column passes, the head's table form with K in passes (and a
    # 16384-wide output), the projection with L in passes of 2048 (its
    # limit grows as sqrt(L / 4096): f32 sums of L exact products in
    # another order)
    for rows, d, dout in WIDE_STAGES:
        w = dict(scale=d ** -0.5, dtype=torch.bfloat16)
        sw = dict(wb=r(d, d, **w), bb=r(d, scale=0.5), g1=1 + r(d, scale=0.2),
                  b1=r(d, scale=0.5), g2=1 + r(d, scale=0.2), b2=r(d, scale=0.5),
                  wv=r(d, d, **w), bv=r(d, scale=0.5), wo=r(d, d, **w), bo=r(d, scale=0.5),
                  wd=r(dout, d, **w), bd=r(dout, scale=0.5))
        h, tc, row = r(rows, d), r(rows, d, scale=0.5), r(d)

        def stwin(tc=tc, row=row, **drop):
            return fused_stage_plain(h, tc, **{**sw, **drop}, row_add=row, eps=LN_EPS)
        run = bind_stage(**sw)
        dropped = {"tc": stwin(tc=None), "row_add": stwin(row=None),
                   "bb": stwin(bb=torch.zeros_like(sw["bb"])),
                   "bd": stwin(bd=torch.zeros_like(sw["bd"]))}
        tag = f"fused_stage {d}->{dout} B={rows}"
        err, tol, weakest = held(tag, run(h, tc, row), stwin(), STAGE_TOL, dropped)
        ms, plain = cuda_ms(lambda: run(h, tc, row)), cuda_ms(stwin)
        n_bytes = 4 * (2 * rows * d + 8 * d + dout + rows * dout) + 2 * (3 * d * d + d * dout)
        b_ms, b_by = bound_ms(n_bytes, 2 * rows * d * (3 * d + dout), BF16_FLOP_PER_S)
        print(f"[wide] {tag} (Wd in passes; plan {run.plan_for(rows)}): max_abs_err {err:.3e} "
              f"(tol {tol:.3e}; least move: {weakest}) ms {ms:.4f} plain_ms {plain:.4f} "
              f"bound_ms {b_ms:.5f} ({b_by})")
        out["fused_stage"]["max_abs_err"] = max(out["fused_stage"]["max_abs_err"], err)
        out["fused_stage"][f"ms_{d}_{dout}_rows_{rows}"] = ms
        out["fused_stage"][f"bound_ms_{d}_{dout}_rows_{rows}"] = b_ms
    for rows, dl, lat in WIDE_TABLE_HEADS:
        hw = dict(g=1 + r(dl, scale=0.2), b=r(dl, scale=0.5),
                  wf=r(lat, dl, scale=dl ** -0.5, dtype=torch.bfloat16), bf=r(lat, scale=0.5))
        h, row, ra = r(rows, dl), r(dl), r(rows, dl, scale=0.5)

        def htwin(row=row, ra=ra, **drop):
            return fused_head_plain(h, None, None, None, None, None, None,
                                    **{**hw, **drop}, row_add=row, rows_add=ra, eps=LN_EPS)
        run = bind_head(None, None, None, None, **hw)
        dropped = {"row_add": htwin(row=None), "rows_add": htwin(ra=None),
                   "g": htwin(g=torch.ones_like(hw["g"])), "b": htwin(b=torch.zeros_like(hw["b"])),
                   "bf": htwin(bf=torch.zeros_like(hw["bf"]))}
        tag = f"fused_head (table adds) {dl}->{lat} B={rows}"
        err, tol, weakest = held(tag, run(h, None, None, row, ra), htwin(), HEAD_TOL, dropped)
        ms, plain = cuda_ms(lambda: run(h, None, None, row, ra)), cuda_ms(htwin)
        n_bytes = 4 * (2 * rows * dl + 3 * dl + lat + rows * lat) + 2 * dl * lat
        b_ms, b_by = bound_ms(n_bytes, 2 * rows * dl * lat, BF16_FLOP_PER_S)
        print(f"[wide] {tag}: max_abs_err {err:.3e} (tol {tol:.3e}; least move: {weakest}) "
              f"ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.5f} ({b_by})")
        out["fused_head"]["max_abs_err"] = max(out["fused_head"]["max_abs_err"], err)
        out["fused_head"][f"table_ms_{dl}_{lat}_rows_{rows}"] = ms
        out["fused_head"][f"table_bound_ms_{dl}_{lat}_rows_{rows}"] = b_ms
    for b, lat, hid in WIDE_PROJECTIONS:
        x, wl, bl = r(b, lat), r(hid, lat, scale=lat ** -0.5, dtype=torch.bfloat16), r(hid)
        run = bind_latent_proj(wl, bl)
        ref = latent_proj_plain(x, wl, bl, copies=2)[0]
        dropped = {"bl": latent_proj_plain(x, wl, torch.zeros_like(bl), copies=2)[0]}
        tag = f"latent_proj {lat}->{hid} B={b} guided"
        rel = PROJ_TOL * max(1.0, (lat / 4096) ** 0.5)
        err, tol, weakest = held(tag, run(x, 2)[0], ref, rel, dropped)
        ms, plain = cuda_ms(lambda: run(x, 2)), cuda_ms(lambda: latent_proj_plain(x, wl, bl,
                                                                                copies=2))
        b_ms, b_by = bound_ms(4 * (b * lat + hid + 2 * b * hid) + 2 * hid * lat,
                              2 * b * lat * hid, BF16_FLOP_PER_S)
        print(f"[wide] {tag}: max_abs_err {err:.3e} (tol {tol:.3e}; least move: {weakest}) "
              f"ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.5f} ({b_by})")
        out["latent_proj"]["max_abs_err"] = max(out["latent_proj"]["max_abs_err"], err)
        out["latent_proj"][f"ms_{lat}_{hid}_rows_{b}"] = ms
        out["latent_proj"][f"bound_ms_{lat}_{hid}_rows_{b}"] = b_ms
    # the product-form head past 2048 (make_fast_denoiser's): the whole rows
    # in device memory
    for rows, dl, de, lat in WIDE_HEADS:
        w = dict(scale=dl ** -0.5, dtype=torch.bfloat16)
        weights = dict(wt=r(dl, de, scale=de ** -0.5, dtype=torch.bfloat16), bt=r(dl, scale=0.5),
                       wc=r(dl, de, scale=de ** -0.5, dtype=torch.bfloat16), bc=r(dl, scale=0.5),
                       g=1 + r(dl, scale=0.2), b=r(dl, scale=0.5), wf=r(lat, dl, **w),
                       bf=r(lat, scale=0.5))
        h, tb, cb = r(rows, dl), r(rows, de), r(rows, de)
        row, ra = r(dl), r(rows, dl, scale=0.5)

        def twin(w_=weights, tb=tb, cb=cb, row=row, ra=ra, **drop):
            return fused_head_plain(h, tb, cb, **{**w_, **drop}, row_add=row, rows_add=ra,
                                    eps=LN_EPS)
        ref = twin()
        dropped = {"t_base": twin(tb=None), "c_base": twin(cb=None), "row_add": twin(row=None),
                   "rows_add": twin(ra=None), "bt": twin(bt=torch.zeros_like(weights["bt"])),
                   "bc": twin(bc=torch.zeros_like(weights["bc"])),
                   "g": twin(g=torch.ones_like(weights["g"])),
                   "b": twin(b=torch.zeros_like(weights["b"])),
                   "bf": twin(bf=torch.zeros_like(weights["bf"]))}
        run = bind_head(**weights)
        reset_counts()
        got = run(h, tb, cb, row, ra)
        counts = launch_counts()
        assert counts["fused_head_products"] == 1 == counts["fused_head"], counts
        tag = f"fused_head (t, c products) {dl}/{de}->{lat} B={rows}"
        err, tol, weakest = held(tag, got, ref, HEAD_TOL, dropped)
        assert torch.equal(run(h, tb, cb, row, ra), got), f"{tag}: repeats differ"
        ms = cuda_ms(lambda: run(h, tb, cb, row, ra))
        plain = cuda_ms(lambda: twin())
        n_bytes = (4 * (2 * rows * dl + 2 * rows * de + 4 * dl + lat + rows * lat)
                   + 2 * (2 * dl * de + dl * lat))
        b_ms, b_by = bound_ms(n_bytes, 2 * rows * (2 * de * dl + dl * lat), BF16_FLOP_PER_S)
        print(f"[wide] {tag}: max_abs_err {err:.3e} (tol {tol:.3e}; least move: {weakest}); "
              f"repeat bit-equal; ms {ms:.4f} plain_ms {plain:.4f} bound_ms {b_ms:.5f} ({b_by})")
        out["fused_head"]["max_abs_err"] = max(out["fused_head"]["max_abs_err"], err)
        out["fused_head"][f"products_ms_{dl}_{de}_{lat}_rows_{rows}"] = ms
        out["fused_head"][f"products_bound_ms_{dl}_{de}_{lat}_rows_{rows}"] = b_ms
    return out


def phase_noise(sched):
    """Zero eps, x_init = 0: x_{t-1} = x_t / sqrt(a_t) + sqrt(b_t) z_t, so
    the variance follows v <- v / a_t + b_t (no noise at t = 0)."""
    dev = torch.device("cuda")
    lat = FLAGSHIP["latent_dim"]
    x = torch.zeros((ROWS, lat), device=dev)
    eps = torch.zeros_like(x)
    coefs = list(zip(sched.alpha.tolist(), sched.alpha_bar.tolist(), sched.beta.tolist()))
    key = key_tensor((2024, 7), dev)
    for t in range(sched.n_steps - 1, -1, -1):
        x = reverse_step(eps, x, t, coefs[t], stochastic=True, key=key)
    v = 0.0
    for t in range(sched.n_steps - 1, 0, -1):
        v = v / float(sched.alpha[t]) + float(sched.beta[t])
    v = v / float(sched.alpha[0])
    var, mean = float(x.var()), float(x.mean())
    print(f"[noise] B={ROWS} L={lat} T={sched.n_steps}: var {var:.5f} closed form "
          f"{v:.5f} mean {mean:.5f}")
    assert abs(var - v) <= 0.05 * v, "noise variance off the closed form"
    # five standard errors of the mean of ROWS * lat draws
    assert abs(mean) <= 5.0 * (v / x.numel()) ** 0.5, "noise mean off zero"


def phase_short_parity(model, gen):
    """Kernel sampler vs the plain f32 model, 20 steps, no step noise, at
    both buckets."""
    sched = linear_schedule(20)
    dev = torch.device("cuda")
    kw = dict(clip_x0=CLIP, guidance_scale=GUIDANCE, device=dev)
    fused = FusedDiffusionSampler(model, sched, (FLAGSHIP["latent_dim"],), **kw)
    plain = DiffusionSampler(model, sched, (FLAGSHIP["latent_dim"],), **kw)
    for rows in BUCKET_ROWS:
        b = rows // 2
        cls = torch.arange(b, device=dev) % FLAGSHIP["num_classes"]
        x0 = torch.randn((b, FLAGSHIP["latent_dim"]), generator=gen, device=dev)
        got = fused.sample(b, cls, x_init=x0, stochastic=False)
        ref = plain.sample(b, cls, x_init=x0, stochastic=False)
        err, scale = max_err(got, ref), float(ref.abs().max())
        print(f"[parity] kernel sampler vs f32 model, B={b}, T=20, CFG {GUIDANCE}, "
              f"clip {CLIP}: max_abs_err {err:.4e} (max|ref| {scale:.3f}, "
              f"tol {3e-2 * scale:.4e})")
        assert err <= 3e-2 * scale, f"B={b}: kernel sampler disagrees with the f32 model"


def phase_profile(model):
    """Host vs device time of the kernel sampler: one guided 50-step call at
    the 64 bucket as one launch of the reverse-process kernel, and one
    through the host loop of the step's kernels (`fused_sample`, its
    oracle), each under torch.profiler (CUPTI). Each call's wall time and device busy time come from that one
    call; a bare call's wall time is printed beside it, to show what the
    profiler adds."""
    sched = linear_schedule(50)
    sampler = FusedDiffusionSampler(model, sched, (FLAGSHIP["latent_dim"],), clip_x0=CLIP,
                                    guidance_scale=GUIDANCE, device="cuda")
    cls = torch.arange(ROWS // 2, device="cuda") % FLAGSHIP["num_classes"]
    steps = sched.n_steps
    calls = {
        "one launch": lambda: sampler.sample(ROWS // 2, cls),
        "host loop": lambda: fused_sample(sampler._prep, ROWS // 2, cls, clip_x0=CLIP,
                                          guidance_scale=GUIDANCE),
    }
    for name, fn in calls.items():
        fn()  # the first call binds the bucket's plan
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wall_prof, kernels = device_profile(fn)
        busy_us = sum(e.self_device_time_total for e in kernels)
        print(f"[profile] {name}: 50 guided steps at bucket 64, one profiled call: wall "
              f"{wall_prof * 1e3:.2f} ms ({wall_prof * 1e6 / steps:.1f} us a step); device "
              f"busy {busy_us / 1e3:.2f} ms ({busy_us / steps:.1f} us a step), idle share "
              f"{1 - busy_us / 1e6 / wall_prof:.3f}; the same call bare: wall "
              f"{wall * 1e3:.2f} ms ({wall * 1e6 / steps:.1f} us a step)")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile]   {e.self_device_time_total / steps:8.2f} us/step "
                  f"x{e.count // steps:<3d} {e.key[:90]}")


def device_profile(fn, tries: int = 3):
    """Run fn() once under torch.profiler: (wall seconds, device-side kernel
    rows). Only DeviceType.CUDA rows count: an aten op's row repeats its
    kernels' time. A profile that hands back no device row at all (CUPTI
    did so for one profile of a dozen on the H100's machine, the launches
    counted and run) is taken again, up to `tries` profiles; the rows of
    the first that has any are returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels:
            return wall, kernels
        print("[profile] a profile recorded no kernel on the card; again", flush=True)
    raise AssertionError(f"the profiler recorded no kernel on the card in {tries} profiles")


def bound_plans(sampler) -> dict:
    """The bound plans of a FusedDiffusionSampler (or of the one a
    NormalizedSampler wraps)."""
    return dict(getattr(sampler, "_inner", sampler).process.bound)


def reset_counts():
    fused_stage.launches = fused_head.launches = reverse_step.launches = 0
    fused_head.product_launches = latent_proj.launches = reverse_process.launches = 0


def sampler_counts(calls=1):
    """The launches of `calls` bucket calls of the kernel sampler: one launch
    of the reverse-process kernel each, and none of the step's own kernels."""
    return {"reverse_process": calls, "fused_stage": 0, "fused_head": 0,
            "fused_head_products": 0, "reverse_step": 0, "latent_proj": 0}


def host_loop_counts(n_steps, calls=1):
    """The launches of `calls` host-loop calls (`fused_sample`) of n_steps
    steps: a step is one projection, four stages, one head (the column-tile
    kernel: none of the head's product form) and one reverse step."""
    stages = len(FLAGSHIP["hidden_dims"]) - 1
    return {"reverse_process": 0, "fused_stage": stages * n_steps * calls,
            "fused_head": n_steps * calls, "fused_head_products": 0,
            "reverse_step": n_steps * calls, "latent_proj": n_steps * calls}


# The sampler's kernels in a profiler's rows, by name: the stage kernel's
# instances count as fused_stage, the head's whole-row kernel as its
# product form.
PROFILE_NAMES = {"process_kernel": "reverse_process", "latent_proj_kernel": "latent_proj",
                 "stage_kernel": "fused_stage", "head_cols_kernel": "fused_head",
                 "head_cols_pass_kernel": "fused_head", "head_kernel": "fused_head_products",
                 "reverse_step_kernel": "reverse_step"}


def profiled_launches(kernels):
    """The sampler's kernel launches in a profile's device rows, by counter
    name (fused_head also counts its product form, as its counter does)."""
    got = dict.fromkeys(sampler_counts(0), 0)
    for e in kernels:
        found = re.search(r"::(\w+)(?:<[^>]*>)?\(", e.key)
        name = found.group(1) if found else None
        if name in PROFILE_NAMES:
            got[PROFILE_NAMES[name]] += e.count
            if name == "head_kernel":
                got["fused_head"] += e.count
    return got


def sampler_bound_ms(prep, batch: int, guided: bool = True):
    """The least time of a bucket call's T steps on the card, as one
    function: every weight, time table, condition row and x read once and
    x written once (bytes), against the T steps' bf16 products at the bf16
    peak plus the reverse steps' ~60 f32 operations an element at the f32
    peak (operations)."""
    model = prep["model"]
    rows, lat, steps = batch * (2 if guided else 1), model.latent_dim, prep["n_steps"]
    hidden = tuple(model.hidden_dims)
    # the kernels' matrices in bf16, their vectors in f32 (the time and
    # condition paths' parameters counted too: a slight over-count)
    weights = sum(w.numel() * (2 if w.ndim == 2 else 4) for w in model.parameters())
    tables = sum(t.numel() * 4 for t in prep["tadds"]) + prep["tadd_final"].numel() * 4
    adds = 4 * rows * sum(hidden)
    n_bytes = weights + tables + adds + 2 * 4 * batch * lat
    flops = 2 * batch * lat * hidden[0] + 2 * rows * hidden[-1] * lat
    for d, dout in zip(hidden[:-1], hidden[1:]):
        flops += 2 * rows * d * (3 * d + dout)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = steps * (flops / BF16_FLOP_PER_S + 60 * batch * lat / F32_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_service(model, vae, stats):
    svc = SamplingService(model, vae, buckets=(8, 64), latent_stats=stats,
                          clip_x0=CLIP, guidance_scale=GUIDANCE, quantize_uint8=True,
                          device="cuda")
    assert svc.request_plan(70) == [64, 8] and svc.request_plan(50) == [64]
    steps = svc.sched.n_steps
    inner = svc.sampler._inner
    process = inner.process
    e0 = process_map_encodes()
    t0 = time.perf_counter()
    svc.warmup()  # binds the 8 and the 64 bucket's plans
    warm_s = time.perf_counter() - t0
    assert sorted(process.bound) == [(8, True), (64, True)], sorted(process.bound)
    print(f"[process] warmup of buckets {svc.buckets}: {warm_s:.2f} s, tensor-map encodes "
          f"{process_map_encodes() - e0}")
    for (b, _), plan in sorted(process.bound.items()):
        active = process_max_clusters(plan)
        print(f"[process] bucket {b} ({2 * b} rows, {steps} steps): plan {plan}; the card runs "
              f"{active} such clusters at once")
        assert plan.waves > 1 or plan.clusters <= active, (plan, active)

    # the kernel against its oracle, the host loop of the step's kernels,
    # from the same seed, every step stochastic, within its limit; the host
    # loop with one term left out more than twice the limit away; the
    # kernel's repeats bit-equal
    kw = dict(stochastic=True, clip_x0=CLIP, guidance_scale=GUIDANCE)
    errs = {}
    for b in (8, 64):
        cls = torch.arange(b, device="cuda") % FLAGSHIP["num_classes"]
        inputs = draw_request(inner._prep, b, cls, None,
                              torch.Generator(device="cuda").manual_seed(5), None, guided=True)
        e0 = process_map_encodes()
        got = process(inputs, **kw)
        again = process(inputs, **kw)
        assert process_map_encodes() == e0, "a bound plan's launch encoded a tensor map"
        ref = run_steps(inner._prep, inputs, **kw)
        err, tol, weakest = held(f"reverse_process bucket {b}, {steps} steps", got, ref,
                                 PROCESS_TOL[(steps, True)], left_out(inner._prep, inputs, kw))
        errs[b] = err
        print(f"[process] bucket {b}: {steps} stochastic guided steps in one launch against the "
              f"host loop from one seed: max_abs_err {err:.3e} (tol {tol:.3e}, "
              f"{PROCESS_TOL[(steps, True)]} x max|host loop| {float(ref.abs().max()):.3f}; "
              f"least move of a left-out term: {weakest}); repeat bit-equal "
              f"{torch.equal(got, again)}")
        assert torch.equal(got, again), f"bucket {b}: repeated launches differ"

    # the host loop's own launches, one 64-bucket call: the step's kernels
    # on the path of the kernel's oracle
    reset_counts()
    cls = torch.arange(64, device="cuda") % FLAGSHIP["num_classes"]
    fused_sample(inner._prep, 64, cls, generator=torch.Generator(device="cuda").manual_seed(5),
                 clip_x0=CLIP, guidance_scale=GUIDANCE)
    torch.cuda.synchronize()
    host = launch_counts()
    print(f"[process] the host loop (fused_sample), one 64-bucket call: launches {host}")
    assert host == host_loop_counts(steps), host

    requests = [
        ("sample_classes(range(10), 5)", lambda: svc.sample_classes(range(10), 5, seed=0), 50),
        ("sample(3)", lambda: svc.sample(np.array([3, 17, 101]), seed=1), 3),
        ("sample(70)", lambda: svc.sample(np.arange(70) % 102, seed=2), 70),
    ]
    bucket_calls = sum(len(svc.request_plan(n)) for _, _, n in requests)
    bound = dict(process.bound)
    reset_counts()
    results = []
    for name, fn, n in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = fn()
        dt = time.perf_counter() - t0
        assert imgs.dtype == np.uint8 and imgs.shape == (n, 64, 64, 3), (name, imgs.shape)
        assert imgs.std() > 0, f"{name}: constant images"
        results.append((name, n, dt))
    got = launch_counts()
    for name, n, dt in results:
        print(f"[service] {name}: plan {svc.request_plan(n)} latency {dt * 1e3:.1f} ms "
              f"{n / dt:.2f} images/s")
    want = sampler_counts(bucket_calls)
    print(f"[service] launches {got} expected {want} for {bucket_calls} bucket calls")
    assert got == want, "the main path did not run through the kernel as expected"
    assert dict(process.bound) == bound, "a request bound a new plan after warmup"

    # what a bucket call launches, read by the profiler: one 64-bucket call
    gen = torch.Generator(device="cuda").manual_seed(6)
    wall, kernels = device_profile(lambda: inner.sample(64, cls, generator=gen))
    seen = profiled_launches(kernels)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[process] one profiled bucket call at 64: the sampler's kernels by name {seen}; "
          f"wall {wall * 1e3:.2f} ms ({wall * 1e6 / steps:.1f} us a step), device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / steps:.1f} us a step), idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}; kernels by device time: " + ", ".join(
              f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
              for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]))
    assert seen == sampler_counts(1), "the profiled call ran other sampler kernels"

    # one bucket call: the launch alone between CUDA events, and the whole
    # call (draws, condition rows, the launch) by the host clock, beside the
    # bound of the T steps
    calls = {}
    for b in (8, 64):
        cls = torch.arange(b, device="cuda") % FLAGSHIP["num_classes"]
        gen = torch.Generator(device="cuda").manual_seed(7)
        inputs = draw_request(inner._prep, b, cls, None, gen, None, guided=True)
        ev, wall = [], []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            process(inputs, **kw)
            end.record()
            torch.cuda.synchronize()
            ev.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            inner.sample(b, cls, generator=gen)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        b_ms, b_by = sampler_bound_ms(inner._prep, b)
        calls[b] = dict(launch_ms=float(np.median(ev)), call_wall_ms=float(np.median(wall)),
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[b])
        print(f"[process] bucket {b}: one launch of {steps} steps {np.median(ev):.3f} ms "
              f"between CUDA events (runs {[round(v, 3) for v in ev]}), the whole bucket call "
              f"{np.median(wall):.3f} ms wall (runs {[round(v, 3) for v in wall]}); bound "
              f"{b_ms:.4f} ms ({b_by}; weights read once)")

    # the decoder's share of a request: decode + quantise of one 64 bucket
    latents = np.random.default_rng(0).standard_normal((50, FLAGSHIP["latent_dim"]))
    svc.decode_latents(latents)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = svc.decode_latents(latents)
    dt = time.perf_counter() - t0
    assert imgs.shape == (50, 64, 64, 3)
    print(f"[service] decode_latents(50): plan {svc.request_plan(50)} {dt * 1e3:.2f} ms")

    # reproducible for a given (seed, request), as uint8 and as f32 images,
    # with no flag set here: the service decodes on cuDNN's deterministic
    # algorithms
    svc32 = SamplingService(model, vae, buckets=(64,), latent_stats=stats, clip_x0=CLIP,
                            guidance_scale=GUIDANCE, device="cuda")
    u8 = [svc.sample_classes(range(10), 5, seed=0) for _ in range(2)]
    f32 = [svc32.sample_classes(range(10), 5, seed=0) for _ in range(2)]
    diff_u8, diff_f32 = int((u8[0] != u8[1]).sum()), int((f32[0] != f32[1]).sum())
    same_path = bool(np.array_equal(
        np.round(np.clip(f32[0], 0.0, 1.0) * 255.0).astype(np.uint8), u8[0]))
    print(f"[service] two identical 50-image requests: uint8 values that differ {diff_u8} of "
          f"{u8[0].size}, f32 values {diff_f32} of {f32[0].size}; the f32 service's images "
          f"quantised equal the uint8 service's: {same_path}")
    assert diff_u8 == 0 and diff_f32 == 0 and same_path, "identical requests differ"
    assert not torch.backends.cudnn.deterministic, "the service left a global flag set"

    # the decode of 64 latents on cuDNN's default algorithms, on its
    # deterministic ones (the service's) and in bf16, in turns
    svc16 = SamplingService(model, vae, buckets=(64,), decode_bf16=True, use_fused=False,
                            device="cuda")
    z = torch.randn((64, FLAGSHIP["latent_dim"]), generator=torch.Generator(device="cuda")
                    .manual_seed(8), device="cuda") * 2.0
    decodes = {"default": lambda: vae.decode(z), "deterministic": lambda: svc32._decode(z),
               "bf16": lambda: svc16._decode(z)}
    dec_ms = {k: [] for k in decodes}
    with torch.no_grad():
        for name in ("default", "deterministic", "bf16", "bf16", "deterministic", "default"):
            dec_ms[name].append(event_ms(decodes[name], 10))
        img32, img16 = decodes["deterministic"](), decodes["bf16"]()
    d = (img16 - img32).abs()
    mae, mx = float(d.mean()), float(d.max())
    print(f"[service] decode of 64 latents, ms between CUDA events (10 calls, two turns): "
          f"cuDNN default algorithms {dec_ms['default']}, deterministic "
          f"{dec_ms['deterministic']}, bf16 (deterministic) {dec_ms['bf16']}; bf16 against "
          f"f32: mean abs {mae:.2e} (limit {1 / 255:.2e}), max abs {mx:.2e} "
          f"(limit {16 / 255:.2e})")
    assert img16.dtype == torch.float32 and mae < 1 / 255 and mx < 16 / 255
    return got, host, calls


def phase_tiny_service():
    """SamplingService over the --tiny preset as configs.tiny_preset makes it
    from the flagship's (denoiser latent 32, hidden (32, 64, 32), time 32,
    50 steps, CFG 7.0, clip 3.0; decoder latent 32, channels (8, 16, 24,
    32)), weights from seeds, buckets 8 and 64, uint8: `warmup` binds each
    bucket's plan, then one 70-image request (a 64 and an 8 bucket call) is
    one launch of the reverse-process kernel a bucket call and none of the
    step's own kernels; its images are uint8 of the decoder's shape, and the
    same request again is bit-equal."""
    from flowerdiff_torch import configs
    from flowerdiff_torch.train.latent_ddpm import create_latent_diffusion_state

    preset = configs.tiny_preset(configs.get_preset("flagship"))
    cfg = preset.latent
    _, model, sched = create_latent_diffusion_state(0, cfg, device="cuda")
    vae_kw = dict(latent_dim=preset.vae.latent_dim, channels=tuple(preset.vae.channels),
                  head_width=preset.vae.head_width, base_size=8)
    vae = vae_from_params(init_numpy_params("vae", seed=1, **vae_kw), device="cuda", **vae_kw)
    svc = SamplingService(model, vae, sched=sched, buckets=(8, 64), clip_x0=cfg.clip_denoised,
                          guidance_scale=cfg.guidance_scale, quantize_uint8=True, device="cuda")
    t0 = time.perf_counter()
    svc.warmup()
    warm = time.perf_counter() - t0
    plans = bound_plans(svc.sampler)
    assert set(plans) == {(8, True), (64, True)}, plans
    calls = svc.request_plan(70)
    reset_counts()
    t0 = time.perf_counter()
    images = svc.sample(np.arange(70) % FLAGSHIP["num_classes"], seed=2)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    assert counts == sampler_counts(len(calls)), counts
    assert images.dtype == np.uint8 and images.shape == (70, 64, 64, 3), images.shape
    again = svc.sample(np.arange(70) % FLAGSHIP["num_classes"], seed=2)
    np.testing.assert_array_equal(images, again)
    print(f"[tiny_service] latent {cfg.latent_dim}, hidden {tuple(cfg.hidden_dims)}, time "
          f"{cfg.time_emb_dim}, T={sched.n_steps}, CFG {cfg.guidance_scale}: warmup {warm:.2f} s "
          f"binds {plans}; 70 images (bucket calls {calls}) in {wall * 1e3:.1f} ms, launches "
          f"{counts}; uint8 {images.shape}, repeat bit-equal")


def event_ms(fn, iters: int) -> float:
    """Mean device time of one of `iters` eager calls, between CUDA events,
    after one call to warm up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) / iters, 4)


def phase_ddim(model, vae, stats, den_params):
    """The service with sampler_kind='ddim': 50 deterministic steps of the
    plain f32 model (no kernel, as in the reference), the 50-image request
    timed, its latents against the same DDIM on the CPU from one x_init,
    two identical requests bit-equal."""
    svc = SamplingService(model, vae, buckets=(8, 64), latent_stats=stats, clip_x0=CLIP,
                          guidance_scale=GUIDANCE, quantize_uint8=True, sampler_kind="ddim",
                          ddim_steps=50, device="cuda")
    assert isinstance(svc.sampler, DDIMSampler) and svc.use_fused
    svc.warmup()
    reset_counts()
    times, outs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(svc.sample_classes(range(10), 5, seed=0))
        times.append((time.perf_counter() - t0) * 1e3)
    assert launch_counts() == sampler_counts(0), "DDIM launched a sampler kernel"
    assert outs[0].dtype == np.uint8 and outs[0].shape == (50, 64, 64, 3) and outs[0].std() > 0
    same = all(np.array_equal(outs[0], o) for o in outs[1:])
    lat_ms = float(np.median(times))
    print(f"[ddim] sample_classes(range(10), 5), 50 DDIM steps, CFG {GUIDANCE}, clip {CLIP}, "
          f"uint8: latency {lat_ms:.1f} ms (runs {[round(v, 1) for v in times]}), "
          f"{50e3 / lat_ms:.1f} images/s; three identical requests bit-equal: {same}")
    assert same, "identical DDIM requests differ"

    classes = np.repeat(np.arange(10), 5)
    x = np.random.default_rng(3).standard_normal((50, FLAGSHIP["latent_dim"])).astype(np.float32)
    got = svc.sample(classes, x_init=x, decode=False)
    cpu_model = denoiser_from_params(den_params, device="cpu", **FLAGSHIP)
    cpu = DDIMSampler(NormalizedSampler(DiffusionSampler(
        cpu_model, linear_schedule(1000), (FLAGSHIP["latent_dim"],), clip_x0=CLIP,
        guidance_scale=GUIDANCE, device="cpu"), *stats), 50)
    t0 = time.perf_counter()
    ref = cpu.sample(50, torch.from_numpy(classes), x_init=torch.from_numpy(x)).numpy()
    cpu_s = time.perf_counter() - t0
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    print(f"[ddim] latents on the card against the CPU from one x_init (TF32 off): max_abs_err "
          f"{err:.3e} (max|CPU| {scale:.3f}, limit {1e-3 * scale:.3e}); the CPU run "
          f"{cpu_s:.1f} s")
    assert err <= 1e-3 * scale, "DDIM on the card disagrees with the CPU"
    return lat_ms


def phase_partial(model):
    """The trajectory and masked samplers at bucket 8, 1000 guided clipped
    steps, no step noise: the plain f32 model (FusedDiffusionSampler
    overrides `sample` only)."""
    dev = torch.device("cuda")
    sched = linear_schedule(1000)
    kw = dict(clip_x0=CLIP, guidance_scale=GUIDANCE, device=dev)
    fused = FusedDiffusionSampler(model, sched, (FLAGSHIP["latent_dim"],), **kw)
    plain = DiffusionSampler(model, sched, (FLAGSHIP["latent_dim"],), **kw)
    cls = torch.arange(8, device=dev)
    x = torch.randn((8, FLAGSHIP["latent_dim"]), generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev)
    t_start = torch.tensor([999, 999, 750, 500, 250, 100, 0, -1], device=dev)
    reset_counts()
    t0 = time.perf_counter()
    x0, traj = fused.sample_with_trajectory(8, cls, x_init=x, stochastic=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    masked = fused.masked_denoise(x, t_start, cls, stochastic=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    assert launch_counts() == sampler_counts(0), "trajectory or masked sampling ran a kernel"
    ref = plain.sample(8, cls, x_init=x, stochastic=False)
    ends = torch.equal(traj[-1], x0)
    chains = torch.equal(masked[:2], ref[:2])
    print(f"[partial] sample_with_trajectory, bucket 8, 1000 steps: {(t1 - t0) * 1e3:.1f} ms, "
          f"trajectory {tuple(traj.shape)}, trajectory[-1] == x0: {ends}; masked_denoise "
          f"(t_start {t_start.tolist()}): {(t2 - t1) * 1e3:.1f} ms, the chains from T-1 "
          f"equal plain sample: {chains} (max_abs_err {max_err(masked[:2], ref[:2]):.3e}), "
          f"x0 equal plain sample: {torch.equal(x0, ref)}")
    assert traj.shape == (1000, 8, FLAGSHIP["latent_dim"]) and torch.isfinite(traj).all()
    assert ends and chains and torch.equal(masked[7], x[7]) and torch.isfinite(masked).all()


def phase_augment(dataset):
    """The augmentation on the card against the CPU on the same injected
    draws (64 images), and the card's own draws against their closed-form
    means, each within five standard errors."""
    augment = make_augment_fn(dataset.max_rotation_deg, dataset.jitter)
    x = dataset.images[:64].float() * (1.0 / 255.0)
    draws = augment.draw(64, torch.Generator().manual_seed(1))
    ref = augment(x.cpu(), draws=draws)
    got = augment(x, draws=draws._replace(**{k: v.cuda() for k, v in draws._asdict().items()}))
    err = max_err(got.cpu(), ref)
    n = 4096
    d = augment.draw(n, torch.Generator(device="cuda").manual_seed(2), "cuda")
    max_rad = dataset.max_rotation_deg * np.pi / 180.0
    stats = {"flip share": (float(d.flip.float().mean()), 0.5, 0.5 / n ** 0.5),
             "angle": (float(d.angle.mean()), 0.0, max_rad / (3 * n) ** 0.5)}
    for k in ("fb", "fc", "fs"):
        stats[k] = (float(getattr(d, k).mean()), 1.0, dataset.jitter / (3 * n) ** 0.5)
    chunk = dataset.images[:255].float() * (1.0 / 255.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ms = event_ms(lambda: augment(chunk, gen), 10)
    print(f"[augment] 64 images on the card against the CPU, same draws: max_abs_err {err:.3e} "
          f"(limit 1e-5); the card's own {n} draws, mean (closed form, 5 standard errors): "
          f"{ {k: (round(m, 5), c, round(5 * se, 5)) for k, (m, c, se) in stats.items()} }; "
          f"a chunk of 255 images {ms:.4f} ms")
    assert err <= 1e-5, "augmentation on the card disagrees with the CPU"
    for k, (m, c, se) in stats.items():
        assert abs(m - c) <= 5 * se, f"{k}: mean {m} off {c}"


def _train_case(model, gen):
    """One step's inputs at B = 64 for the model's widths: draws at dropout
    0.3, and a condition keep-mask with every fourth row zero."""
    dev = torch.device("cuda")
    sched = linear_schedule(1000).to(dev)
    z = torch.randn((TRAIN_BATCH, model.latent_dim), generator=gen, device=dev)
    labels = torch.randint(0, FLAGSHIP["num_classes"], (TRAIN_BATCH,), generator=gen, device=dev)
    t, eps, _, masks = ts.draw_step_inputs(model, 1000, 0.0, z, gen)
    keep = (torch.arange(TRAIN_BATCH, device=dev) % 4 != 0).float()
    data = ts.step_data(sched, z, labels, t, eps, keep,
                        ts.sinusoid_freqs(model.time_emb_dim, dev))
    return data, masks


def _worst_leaf(grads, ref):
    """(largest error of a leaf relative to its max|twin grad|, that leaf,
    largest absolute error)."""
    worst_rel, worst_abs, worst_leaf = 0.0, 0.0, ""
    for k, r in ref.items():
        err = (grads[k].reshape(r.shape) - r).abs()
        rel = float(err.max() / (r.abs().max() + 1e-30))
        if rel > worst_rel:
            worst_rel, worst_leaf = rel, k
        worst_abs = max(worst_abs, float(err.max()))
    return worst_rel, worst_leaf, worst_abs


RAGGED_WIDTH = 254  # latent and time embedding whose rows tensor maps cannot read


def ragged_train_step(gen) -> dict:
    """The bf16 step at latent and time embedding 254 with the flagship's
    hidden widths (under the v2 skip the last one 254 too): its products'
    kernels from the plan, loss and every leaf against autograd on the twin
    at the bf16 limit (a hard gate), no encode a step, ms in a CUDA graph."""
    out = {}
    for skip in (False, True):
        hidden = FLAGSHIP["hidden_dims"][:-1] + ((RAGGED_WIDTH,) if skip else (256,))
        kw = dict(FLAGSHIP, latent_dim=RAGGED_WIDTH, time_emb_dim=RAGGED_WIDTH,
                  hidden_dims=hidden, global_skip=skip)
        model = denoiser_from_params(init_numpy_params("denoiser", seed=3, **kw),
                                     device="cuda", **kw)
        perturb_module(model, gen)
        named = dict(ts.weights_spec(model))
        data, masks = _train_case(model, gen)
        run = ts.bind_train_step(named, TRAIN_BATCH, dtype=torch.bfloat16, global_skip=skip)
        kernels = {}
        for q in run.products():
            kernels[q["kernel"]] = kernels.get(q["kernel"], 0) + 1
            ragged = any(4 * v % 16 for v in q["strides"])
            assert not (ragged and q["kernel"] == "wgmma"), q
        assert kernels.get("mma_dw", 0) > 0 and kernels.get("splitk", 0) > 0, kernels
        loss, grads = run(data, masks)
        torch.cuda.synchronize()
        e0 = ts.tensor_map_encodes()
        ref_loss, ref = ts.twin_loss_and_grads(named, data, masks, dtype=torch.bfloat16,
                                               global_skip=skip)
        worst_rel, worst_leaf, worst_abs = _worst_leaf(grads, ref)
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
        assert worst_rel <= TRAIN_BF16_REL, (
            f"ragged train_step skip={skip}: leaf {worst_leaf} off by {worst_rel} x max|twin "
            f"grad| > {TRAIN_BF16_REL}")
        assert loss_rel <= TRAIN_BF16_REL
        ms = cuda_ms(lambda: run(data, masks), iters=20)
        torch.cuda.synchronize()
        assert ts.tensor_map_encodes() == e0, "a bound ragged step encoded a tensor map"
        print(f"[train_kernel] ragged widths (latent, time embedding {RAGGED_WIDTH}, hidden "
              f"{hidden}) skip={skip} bf16: products on {kernels}; loss {float(loss):.6f} (twin "
              f"{float(ref_loss):.6f}, rel {loss_rel:.2e}); worst leaf {worst_leaf} "
              f"{worst_rel:.3e} x max|twin grad| (abs {worst_abs:.3e}, limit {TRAIN_BF16_REL}); "
              f"ms {ms:.4f}; tensor-map encodes a step 0")
        out[f"skip={skip}"] = dict(ms=ms, max_rel_err=worst_rel, kernels=kernels)
    return out


# 40 stages of 128: ~27 MiB of f32 weights and gradients, which the JAX
# train kernels hold in their 120 MiB of VMEM; past the 16 stages the train
# kernels' host structs once held. The step's net is a residual stream
# (`residual_stream`): from the plain seeded tree the bf16 lane's rounding
# of each incoming gradient before its products, where the twin rounds
# after them, builds up over 40 stages to 1.98e-2 of wl's largest gradient
# on an H100 (PERF.md) against TRAIN_BF16_REL; the f32 lane agrees either
# way (tools/depth_probe.py shows it on the CPU).
DEEP_TRAIN = dict(latent_dim=128, hidden_dims=(128,) * 41, time_emb_dim=64,
                  num_classes=FLAGSHIP["num_classes"])


def deep_train_step() -> dict:
    """The train-step kernel bound to the 40-stage net (a residual stream)
    at B = 64, both lanes: one launch a step, no encode a step, loss and
    every leaf against
    autograd on the twin (f32: the per-leaf limits; bf16: TRAIN_BF16_REL of
    the leaf's largest gradient), ms in a CUDA graph."""
    gen = torch.Generator(device="cuda").manual_seed(22)  # the later phases' draws as before
    model = denoiser_from_params(
        residual_stream(init_numpy_params("denoiser", seed=3, **DEEP_TRAIN)), device="cuda",
        **DEEP_TRAIN)
    perturb_module(model, gen)
    named = dict(ts.weights_spec(model))
    assert len(named) == 11 + 14 * 40 + 9
    data, masks = _train_case(model, gen)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        lane = "f32" if dtype == torch.float32 else "bf16"
        run = ts.bind_train_step(named, TRAIN_BATCH, dtype=dtype)
        before = ts.kernel_loss_and_grads.launches
        loss, grads = run(data, masks)
        torch.cuda.synchronize()
        assert ts.kernel_loss_and_grads.launches == before + 1
        e0 = ts.tensor_map_encodes()
        ref_loss, ref = ts.twin_loss_and_grads(named, data, masks, dtype=dtype)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
        worst_rel, worst_leaf, worst_abs = _worst_leaf(grads, ref)
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        if dtype == torch.float32:
            for k, r in ref.items():
                err = (grads[k].reshape(r.shape) - r).abs()
                over = float((err - (TRAIN_F32_ATOL + TRAIN_F32_RTOL * r.abs())).max())
                assert over <= 0, f"deep train_step f32: leaf {k} over by {over}"
            assert loss_rel <= 1e-5, f"deep train_step f32 loss off by {loss_rel}"
        else:
            assert worst_rel <= TRAIN_BF16_REL, (
                f"deep train_step bf16: leaf {worst_leaf} off by {worst_rel} x max|twin grad| "
                f"> {TRAIN_BF16_REL}")
            assert loss_rel <= TRAIN_BF16_REL
        ms = cuda_ms(lambda: run(data, masks), iters=10)
        torch.cuda.synchronize()
        assert ts.tensor_map_encodes() == e0, "a bound deep step encoded a tensor map"
        n_bytes, flops = train_step_counts(named, TRAIN_BATCH)
        b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S if dtype == torch.float32
                              else BF16_FLOP_PER_S)
        print(f"[train_kernel] 40 stages of 128 {lane}: {len(run.products())} products; loss "
              f"{float(loss):.6f} (twin {float(ref_loss):.6f}, rel {loss_rel:.2e}); worst leaf "
              f"{worst_leaf} {worst_rel:.3e} x max|twin grad| (abs {worst_abs:.3e}); ms "
              f"{ms:.4f}; bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP at the {lane} peak); tensor-map encodes a step 0")
        out[lane] = dict(ms=ms, max_rel_err=worst_rel, bound_ms=b_ms, bound_by=b_by)
    return out


def train_step_counts(named, batch):
    """(bytes, flops) one step must move and do: every weight read once and
    every gradient written once in f32, the batch's inputs and masks read
    once; per weight matrix the forward product, dW, and dX where the input
    itself needs a gradient (not for the three first layers)."""
    w_bytes = sum(4 * v.numel() for v in named.values())
    hidden = [named["wl"].shape[0]] + [named[k].shape[0] for k in named if k.endswith(".wd")]
    lat, te = named["wl"].shape[1], named["wt2"].shape[0]
    io = 4 * batch * (2 * lat + 5 + 2 * sum(hidden[:-1])) + 4 * (te // 2) + 4
    flops = 0
    for k, v in named.items():
        if v.ndim == 2 and k != "table":
            flops += 2 * batch * v.numel() * (2 if k in ("wl", "wt1", "wc1") else 3)
    flops += 2 * batch * named["wc1"].numel()  # wc1's dX feeds the table's gradient
    return 2 * w_bytes + io, flops


_PRODUCT_SUMS: dict = {}


def product_sums() -> dict:
    """Each bf16 product of a flagship step (`gemm_ab.step_products`: B = 64,
    hidden (256, 512, 1024, 512, 256), time embedding and latent 256) alone,
    by form: launches a step, the kernels' us summed over the step (each
    shape timed once by `cuda_ms` on random operands, times its count), and
    the yardstick, one bf16 `torch.matmul` a product on bf16 copies of the
    same operands (timed here only; the port never calls it). Measured once a
    process; `library_ms` of the train_step and train_epoch rows."""
    if _PRODUCT_SUMS:
        return _PRODUCT_SUMS
    gen = torch.Generator(device="cuda").manual_seed(5)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for (form, m, n, k), count in step_products().items():
        if form == "fwd":  # Y (B, out) = X W^T + b: M = B, N = out, K = in
            x, w, b = r(m, k), r(n, k, scale=k ** -0.5), r(n)
            fn = lambda: ts.linear_forward(x, w, b, exact=False)  # noqa: E731
            a16, b16 = x.to(torch.bfloat16), w.to(torch.bfloat16).t()
        elif form == "dx":  # dX (B, in) = dY W: M = B, N = in, K = out
            dy, w = r(m, k), r(k, n, scale=n ** -0.5)
            fn = lambda: ts.linear_dx(dy, w, exact=False)  # noqa: E731
            a16, b16 = dy.to(torch.bfloat16), w.to(torch.bfloat16)
        else:  # dW (out, in) = dY^T X: M = out, N = in, K = B
            dy, x = r(k, m), r(k, n)
            fn = lambda: ts.linear_dw(dy, x, exact=False)  # noqa: E731
            a16, b16 = dy.to(torch.bfloat16).t(), x.to(torch.bfloat16)
        kernel_us = 1e3 * cuda_ms(fn)
        lib_us = 1e3 * cuda_ms(lambda: torch.matmul(a16, b16))  # noqa: B023
        agg = _PRODUCT_SUMS.setdefault(form, {"launches": 0, "us": 0.0, "library_us": 0.0,
                                              "kernels": {}})
        agg["launches"] += count
        agg["us"] += count * kernel_us
        agg["library_us"] += count * lib_us
        kernel = ts.product_plan(form, m, n, k)["kernel"]
        agg["kernels"][kernel] = agg["kernels"].get(kernel, 0) + count
    return _PRODUCT_SUMS


def phase_train_kernel(gen):
    """The train-step kernel against autograd on its twin at flagship width,
    and its time beside the eager autograd steps and the bound."""
    row = {"name": "train_step", "route": "cuda",
           "source": "src/flowerdiff_torch/kernels/csrc/train_step.cuh",
           "replaces": "src/flowerdiff/kernels/train_step.py:267",
           "max_abs_err": 0.0, "library_ms": None}
    worst_bf16 = 0.0
    for skip in (False, True):
        kw = dict(FLAGSHIP, global_skip=skip)
        model = denoiser_from_params(init_numpy_params("denoiser", seed=3, **kw),
                                     device="cuda", **kw)
        # the biases a LayerNorm reads next drawn wider, so that leaving any
        # one out shows on any draw (tools/train_gate.py)
        perturb_module(model, gen, PRE_LN_BIAS_SCALE)
        named = dict(ts.weights_spec(model))
        assert len(named) == 76
        data, masks = _train_case(model, gen)
        for dtype in (torch.float32, torch.bfloat16):
            lane = "f32" if dtype == torch.float32 else "bf16"
            e_bind = ts.tensor_map_encodes()
            run = ts.bind_train_step(named, TRAIN_BATCH, dtype=dtype, global_skip=skip)
            e_bind = ts.tensor_map_encodes() - e_bind
            before = ts.kernel_loss_and_grads.launches
            loss, grads = run(data, masks)
            torch.cuda.synchronize()
            assert ts.kernel_loss_and_grads.launches == before + 1
            e0 = ts.tensor_map_encodes()
            for _ in range(3):
                run(data, masks)
            torch.cuda.synchronize()
            e_steps = ts.tensor_map_encodes() - e0
            n_maps = 3 * sum(1 for q in run.products() if q["kernel"] == "wgmma")
            print(f"[train_kernel] skip={skip} {lane}: tensor-map encodes at bind {e_bind} (3 a "
                  f"wgmma product: {n_maps}), a step after bind {e_steps / 3:.1f}")
            assert e_bind == n_maps and e_steps == 0, (e_bind, n_maps, e_steps)
            ref_loss, ref = ts.twin_loss_and_grads(named, data, masks, dtype=dtype,
                                                   global_skip=skip)
            assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
            if dtype == torch.float32:
                for k, r in ref.items():
                    err = (grads[k].reshape(r.shape) - r).abs()
                    over = float((err - (TRAIN_F32_ATOL + TRAIN_F32_RTOL * r.abs())).max())
                    assert over <= 0, f"train_step f32 skip={skip}: leaf {k} over by {over}"
            worst_rel, worst_leaf, worst_abs = _worst_leaf(grads, ref)
            loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
            if dtype == torch.bfloat16:
                assert worst_rel <= TRAIN_BF16_REL, (
                    f"train_step bf16 skip={skip}: leaf {worst_leaf} off by {worst_rel} "
                    f"x max|twin grad| > {TRAIN_BF16_REL}")
                assert loss_rel <= TRAIN_BF16_REL
                worst_bf16 = max(worst_bf16, worst_rel)
                row["max_abs_err"] = max(row["max_abs_err"], worst_abs)
            else:
                assert loss_rel <= 1e-5, f"train_step f32 loss off by {loss_rel}"
            # q and k of every stage: exactly zero; rw: zero without the skip
            tree = ts.grads_to_tree(grads, model)
            assert all(not g.any() for n, g in tree.items() if ".q." in n or ".k." in n)
            assert bool(tree["residual_weight"].any()) == skip
            ms = cuda_ms(lambda: run(data, masks), iters=20)
            print(f"[train_kernel] skip={skip} {lane}: loss {float(loss):.6f} (twin "
                  f"{float(ref_loss):.6f}, rel {loss_rel:.2e}); worst leaf {worst_leaf} "
                  f"{worst_rel:.3e} x max|twin grad| (abs {worst_abs:.3e}); ms {ms:.4f}")
            if not skip:
                row["ms" if dtype == torch.bfloat16 else "f32_lane_ms"] = ms

        if skip:
            continue
        # leaving out any one term moves some gradient past twice the limit
        moves = left_out_moves(named, data, masks)
        weakest = min(moves, key=moves.get)
        print(f"[train_kernel] {len(moves)} left-out terms; the least move of any: {weakest} "
              f"{moves[weakest]:.3g} x max|grad| (limit {TRAIN_BF16_REL})")
        assert moves[weakest] > 2 * TRAIN_BF16_REL, (
            f"leaving out {weakest} moves the gradients only {moves[weakest]}")

        # the eager autograd steps beside the kernel (wall time, synchronised)
        def twin_step():
            return ts.twin_loss_and_grads(named, data, masks, dtype=torch.bfloat16)

        twin_ms = cuda_ms(twin_step, iters=5)
        twin_eager = eager_ms(twin_step, iters=10)
        params = list(model.parameters())
        pairs = list(zip(masks[0::2], masks[1::2]))
        x_t = data["sa"] * data["z"] + data["s1a"] * data["eps"]
        t_int, labels = data["t_f"][:, 0].long(), data["labels"].long()

        def module_step():
            for q in params:
                q.requires_grad_(True)
            out = model.train()(x_t, t_int, labels, cond_mask=data["cond_mask"][:, 0],
                                masks=pairs)
            loss = torch.sqrt(((data["eps"] - out) ** 2).sum(dim=1) + 1e-8).mean()
            return torch.autograd.grad(loss, params, allow_unused=True)

        module_eager = eager_ms(module_step, iters=10)
        n_bytes, flops = train_step_counts(named, TRAIN_BATCH)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
        eager_kernel = eager_ms(lambda: run(data, masks), iters=20)
        print(f"[train_kernel] B={TRAIN_BATCH} flagship: kernel bf16 {row['ms']:.4f} ms, f32 "
              f"lane {row['f32_lane_ms']:.4f} ms (CUDA graph), {eager_kernel:.4f} ms eager; "
              f"autograd on the twin {twin_ms:.4f} ms (CUDA graph) / {twin_eager:.4f} ms eager; "
              f"autograd on the f32 module {module_eager:.4f} ms eager; bound {b_ms:.5f} ms "
              f"({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        n_prof = 10
        _, kernels = device_profile(lambda: [run(data, masks) for _ in range(n_prof)])
        busy = sum(e.self_device_time_total for e in kernels) / n_prof
        print(f"[train_kernel] profile of {n_prof} bf16 steps: "
              f"{sum(e.count for e in kernels) // n_prof} launches and {busy:.1f} us busy a step")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"[train_kernel]   {e.self_device_time_total / n_prof:8.1f} us/step "
                  f"x{e.count // n_prof:<3d} {e.key[:80]}")
        row.update(plain_ms=twin_ms, bound_ms=b_ms, bound_by=b_by,
                   eager_autograd_twin_ms=twin_eager, eager_autograd_module_ms=module_eager)
    sums = product_sums()
    for form, agg in sums.items():
        print(f"[train_kernel] bf16 {form} products of a step: {agg['launches']} launches on "
              f"{agg['kernels']}, {agg['us']:.2f} us alone; torch.matmul bf16 "
              f"{agg['library_us']:.2f} us")
    row["library_ms"] = sum(agg["library_us"] for agg in sums.values()) / 1e3
    row["products_ms"] = sum(agg["us"] for agg in sums.values()) / 1e3
    print(f"[train_kernel] the {sum(a['launches'] for a in sums.values())} bf16 products of a "
          f"step alone {row['products_ms']:.4f} ms; library_ms (one bf16 torch.matmul a "
          f"product) {row['library_ms']:.4f}")
    row["max_rel_err"] = worst_bf16
    row["ragged"] = ragged_train_step(gen)
    row["deep"] = deep_train_step()
    return row


def phase_train(vae, stats, dataset):
    """The flagship latent-DDPM trainer on cached latents of augmented
    images, 10 epochs, with the train-step kernel and with eager autograd
    from the same seed."""
    dev = torch.device("cuda")
    epochs, steps = 10, TRAIN["steps_per_epoch"]

    def config(train_kernel, lane="bfloat16"):
        return LatentDiffusionConfig(train_kernel=train_kernel, train_kernel_dtype=lane,
                                     **FLAGSHIP, **TRAIN)

    # the K = 8 pool alone: its build time with and without augmentation,
    # and bf16 against f32 convolutions
    cfg = config(False)
    gen = torch.Generator(device=dev).manual_seed(11)
    tstats = tuple(torch.as_tensor(s, dtype=torch.float32, device=dev) for s in stats)
    aug = dict(max_rotation_deg=dataset.max_rotation_deg, jitter=dataset.jitter)
    assert dataset.augment_enabled and aug == dict(max_rotation_deg=10.0, jitter=0.2)
    build = make_latent_cache_builder(vae, cfg, **aug)
    build_plain = make_latent_cache_builder(vae, cfg, augment=False)
    build_ms = {}
    for name, fn in (("augmented", build), ("not augmented", build_plain)):
        fn(dataset.images, gen, tstats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(dataset.images, gen, tstats)
        torch.cuda.synchronize()
        build_ms[name] = (time.perf_counter() - t0) * 1e3
        if name == "augmented":
            pool = out
    pool_ms = build_ms["augmented"]
    pool32 = make_latent_cache_builder(vae, dataclasses.replace(cfg, encode_dtype=None),
                                       **aug)(dataset.images, gen, tstats)
    assert pool.shape == (8, 1020, FLAGSHIP["latent_dim"]) and pool.dtype == torch.float32
    assert torch.isfinite(pool).all()
    d_mean = float((pool.mean(dim=(0, 1)) - pool32.mean(dim=(0, 1))).abs().max())
    d_std = float((pool.std(dim=(0, 1)) / pool32.std(dim=(0, 1)) - 1).abs().max())
    print(f"[train] pool (8, 1020, 256) of augmented images built in {pool_ms:.1f} ms (without "
          f"augmentation {build_ms['not augmented']:.1f} ms; bf16 encoder); per-dim "
          f"mean within {d_mean:.3f} and std within {d_std:.3f} (relative) of the f32 "
          f"encoder's pool; pool std {float(pool.std()):.3f}")
    assert d_mean < 0.1 * float(pool32.std()) and d_std < 0.1

    runs = {}
    for name, kernel, lane, n_epochs in (("kernel bf16", True, "bfloat16", epochs),
                                         ("eager autograd", False, "bfloat16", epochs),
                                         ("kernel f32", True, "float32", 1)):
        trainer = LatentDiffusionTrainer(config(kernel, lane), vae, seed=4, latent_stats=stats)
        gen = torch.Generator(device=dev).manual_seed(12)
        reset_counts()
        ts.kernel_loss_and_grads.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.run_epochs_fused(dataset, n_epochs, vae, gen, batch_size=TRAIN_BATCH)
        dt = time.perf_counter() - t0
        launches = ts.kernel_loss_and_grads.launches
        assert len(losses) == n_epochs and np.all(np.isfinite(trainer.last_step_losses))
        assert launches == (n_epochs * steps if kernel else 0), (name, launches)
        assert trainer.state.step == n_epochs * steps and trainer._pool_builds == 1
        runs[name] = (trainer, losses, trainer.last_step_losses, launches)
        print(f"[train] {name}: {n_epochs} epochs x {steps} steps in {dt * 1e3:.1f} ms, pool "
              f"build included ({(dt * 1e3 - pool_ms) / (n_epochs * steps):.3f} ms a step "
              f"without it); train-step launches {launches}; epoch losses "
              f"{[round(v, 4) for v in losses]}")
    k_steps, e_steps, f_steps = (runs[n][2] for n in ("kernel bf16", "eager autograd",
                                                      "kernel f32"))
    rel_bf16 = float(np.max(np.abs(k_steps[:steps] - e_steps[:steps]) / e_steps[:steps]))
    rel_f32 = float(np.max(np.abs(f_steps - e_steps[:steps]) / e_steps[:steps]))
    print(f"[train] first {steps} steps against eager autograd: bf16 lane within "
          f"{rel_bf16:.3e} (limit {TRAIN_CURVE_REL}), f32 lane within {rel_f32:.3e} "
          f"(limit 1e-4)")
    assert rel_bf16 <= TRAIN_CURVE_REL and rel_f32 <= 1e-4
    for name in ("kernel bf16", "eager autograd"):
        losses = runs[name][1]
        assert losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}"

    # host against device: one more epoch of each body under the profiler
    for name in ("kernel bf16", "eager autograd"):
        trainer = runs[name][0]
        gen = torch.Generator(device=dev).manual_seed(14)
        wall, kernels = device_profile(lambda: trainer.run_epochs_fused(
            dataset, 1, vae, gen, batch_size=TRAIN_BATCH))
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        print(f"[train] {name}, one profiled epoch: wall {wall * 1e3 / steps:.3f} ms a step, "
              f"device busy {busy * 1e3 / steps:.3f} ms a step, idle share "
              f"{1 - busy / wall:.3f}")

    # train and serve meet: the EMA weights through the kernel sampler, then the decoder
    trainer = runs["kernel bf16"][0]
    live = dict(zip(trainer.state.names, trainer.state.params))
    ema = trainer.sampling_params
    assert any(not torch.equal(ema[k], live[k]) for k in live), "EMA equals the live weights"
    sampler = trainer.sampler(fused=True)
    cls = torch.arange(16, device=dev) % FLAGSHIP["num_classes"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = sampler.sample(16, cls, generator=torch.Generator(device=dev).manual_seed(13))
    with torch.no_grad():
        imgs = vae.decode(z)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert z.shape == (16, FLAGSHIP["latent_dim"]) and torch.isfinite(z).all()
    assert imgs.shape == (16, 64, 64, 3) and torch.isfinite(imgs).all()
    n_t = trainer.sched.n_steps
    # the first call of a fresh sampler binds its plan, then launches once
    assert launch_counts() == sampler_counts(1), launch_counts()
    assert len(bound_plans(sampler)) == 1
    print(f"[train] sampler(fused=True) on the EMA weights: 16 images, {n_t} guided steps "
          f"(CFG {GUIDANCE}, clip {CLIP}) + decode in {dt * 1e3:.1f} ms (the binding of its plan "
          f"included); launches {launch_counts()}")
    return runs["kernel bf16"][3], pool


def phase_uncached(vae, stats, dataset):
    """Uncached training as users run it with epoch_encode: each epoch's 960
    augmented images through one bf16 encoder call, then 15 bf16
    train-step kernel steps, 2 epochs through the trainer (the kernel's
    launches counted); then the epoch-encode form against the per-step
    form (eager autograd, an encode a step) from one generator, f32 lane,
    f32 encoder, on the first 5 steps."""
    dev = torch.device("cuda")
    steps = TRAIN["steps_per_epoch"]
    uncached = dict(TRAIN, latent_cache=0, cache_refresh_epochs=0)
    cfg = LatentDiffusionConfig(**FLAGSHIP, **uncached, epoch_encode=True, train_kernel=True)
    assert cfg.encode_dtype == "bfloat16" and cfg.train_kernel_dtype == "bfloat16"
    trainer = LatentDiffusionTrainer(cfg, vae, seed=4, latent_stats=stats)
    gen = torch.Generator(device=dev).manual_seed(16)
    ts.kernel_loss_and_grads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.run_epochs_fused(dataset, 2, vae, gen, batch_size=TRAIN_BATCH)
    dt = (time.perf_counter() - t0) * 1e3
    launches = ts.kernel_loss_and_grads.launches
    finite = bool(np.all(np.isfinite(trainer.last_step_losses)))
    assert finite and len(losses) == 2 and trainer.state.step == 2 * steps
    assert launches == 2 * steps, f"uncached training launched the train step {launches} times"
    wall, kernels = device_profile(lambda: trainer.run_epochs_fused(
        dataset, 1, vae, gen, batch_size=TRAIN_BATCH))
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"[uncached] 2 epochs x {steps} steps of {TRAIN_BATCH}, augmented, one bf16 encode of "
          f"{steps * TRAIN_BATCH} images an epoch, bf16 train-step kernel: {dt:.1f} ms "
          f"({dt / 2:.1f} ms an epoch, first-call builds included); train-step launches "
          f"{launches}; epoch losses {[round(v, 4) for v in losses]}; one profiled epoch: wall "
          f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, idle share "
          f"{1 - busy / wall:.3f}")

    idx = torch.from_numpy(epoch_rows(3, dataset.n, TRAIN_BATCH, 1)[0][:5]).to(dev)
    tstats = tuple(torch.as_tensor(s, dtype=torch.float32, device=dev) for s in stats)
    forms = {}
    for name, over in (("per-step encode, eager", dict()),
                       ("epoch encode, kernel f32", dict(epoch_encode=True, train_kernel=True,
                                                         train_kernel_dtype="float32"))):
        fcfg = LatentDiffusionConfig(**FLAGSHIP, **dict(uncached, encode_dtype=None), **over)
        t = LatentDiffusionTrainer(fcfg, vae, seed=4, latent_stats=stats)
        fn = make_fused_latent_epochs(t.model, vae, t.sched, fcfg, steps_per_epoch=5)
        forms[name] = fn(t.state, dataset.images, dataset.labels, None, idx,
                         torch.Generator(device=dev).manual_seed(17), tstats).cpu()
    a, b = forms.values()
    err, scale = float((a - b).abs().max()), float(a.abs().max())
    print(f"[uncached] the first 5 steps, per-step encode (eager) against epoch encode (kernel, "
          f"f32 lane) from one generator: losses {[round(float(v), 5) for v in a]}, max diff "
          f"{err:.3e} (limit {1e-4 * scale:.3e})")
    assert err <= 1e-4 * scale, "the two forms of the uncached epochs disagree"
    return launches


def _state_snapshot(state):
    lists = (state.params, state.mu, state.nu, state.ema or [])
    return [[t.clone() for t in lst] for lst in lists], state.step


def _state_restore(state, snapshot):
    saved, step = snapshot
    for lst, keep in zip((state.params, state.mu, state.nu, state.ema or []), saved):
        for t, k in zip(lst, keep):
            t.copy_(k)
    state.step = step


def _over(got, ref, rtol, atol):
    """The largest |got - ref| / (atol + rtol |ref|) over a list of tensors:
    above 1 some element is outside the limit."""
    return max(float(((g - r).abs() / (atol + rtol * r.abs())).max())
               for g, r in zip(got, ref))


def _epoch_readings(got_losses, got, ref_losses, ref, sum_lr):
    """Kernel state against twin state after one epoch, in units of the
    limits (a value above 1 is a failure): f32 limits and bf16 limits."""
    qk = [j for j, n in enumerate(ref.names) if ".q." in n or ".k." in n]
    rest = [j for j in range(len(ref.names)) if j not in qk]

    def pick(lst, idx):
        return [lst[j] for j in idx]

    def by_slot(lst):
        return {j: lst[j] for j in rest}

    loss_rel = float(((got_losses - ref_losses).abs() / ref_losses.abs()).max())
    w_got, w_ref = pick(got.params, rest), pick(ref.params, rest)
    f32 = {"loss": loss_rel / EPOCH_LOSS_RTOL,
           "w": _over(w_got, w_ref, EPOCH_W_RTOL, EPOCH_W_ATOL),
           "mu": _over(pick(got.mu, rest), pick(ref.mu, rest), EPOCH_W_RTOL, EPOCH_W_ATOL),
           "nu": _over(pick(got.nu, rest), pick(ref.nu, rest), EPOCH_W_RTOL, EPOCH_NU_ATOL),
           "q, k": _over(pick(got.params, qk), pick(ref.params, qk), EPOCH_QK_RTOL, 0.0)}
    if ref.ema is not None:
        f32["ema"] = _over(pick(got.ema, rest), pick(ref.ema, rest), EPOCH_W_RTOL, EPOCH_W_ATOL)
    w_mean = max(float((g - r).abs().mean()) for g, r in zip(w_got, w_ref))
    w_max = max(float((g - r).abs().max()) for g, r in zip(w_got, w_ref))
    bf16 = {"loss": loss_rel / EPOCH_BF16_LOSS_REL,
            "mu": moved(by_slot(got.mu), by_slot(ref.mu)) / EPOCH_BF16_MOMENT_REL,
            "nu": moved(by_slot(got.nu), by_slot(ref.nu)) / EPOCH_BF16_MOMENT_REL,
            "w mean": w_mean / (EPOCH_BF16_W_MEAN * sum_lr),
            "w max": w_max / (2 * sum_lr + 1e-6),
            "q, k": f32["q, k"]}
    return f32, bf16, w_max


def _gather_rows(pool, dataset, seed, epochs, gen):
    """z_rows (T, B, L) and labels (T, B) for `epochs` epochs: each sample a
    uniformly drawn slot of the K-slot pool, as the cached trainer gathers."""
    idx, steps = epoch_rows(seed, dataset.n, TRAIN_BATCH, epochs)
    assert steps == EPOCH_STEPS
    idx = torch.from_numpy(idx).to(pool.device)
    slot = torch.randint(0, pool.shape[0], idx.shape, generator=gen, device=pool.device)
    z = pool.reshape(-1, pool.shape[-1])[slot * dataset.n + idx]
    return z, dataset.labels[idx]


def _check_draws(draws, n_steps, rate, cond_dropout):
    """The distribution of one epoch's draws (960 samples): every bound is
    five standard errors of the statistic under the intended distribution."""
    t, eps, keep, masks = draws
    n = t.numel()
    assert float(t.min()) >= 0 and float(t.max()) <= n_steps - 1 and torch.equal(t, t.floor())
    var_u = (n_steps ** 2 - 1) / 12.0
    t_mean, t_var = float(t.mean()), float(t.var())
    assert abs(t_mean - (n_steps - 1) / 2) <= 5 * (var_u / n) ** 0.5, t_mean
    assert abs(t_var - var_u) <= 5 * var_u * (0.8 / n) ** 0.5, t_var  # kurtosis 1.8
    e_mean, e_var = float(eps.mean()), float(eps.var())
    assert abs(e_mean) <= 5 * eps.numel() ** -0.5, e_mean
    assert abs(e_var - 1) <= 5 * (2 / eps.numel()) ** 0.5, e_var
    assert torch.isfinite(eps).all() and float(eps.abs().max()) < 6.0
    k_rate = float(keep.mean())
    assert set(keep.unique().tolist()) <= {0.0, 1.0}
    assert abs(k_rate - (1 - cond_dropout)) <= 5 * (cond_dropout * (1 - cond_dropout) / n) ** 0.5
    rates = []
    for j, m in enumerate(masks):
        steps, rows, d = m.shape
        scale = 1.0 / (1.0 - rate)
        assert bool(((m == 0) | ((m - scale).abs() < 1e-6)).all()), f"mask {j}: other values"
        draws_n = m.numel()
        if j % 2:  # one draw a (sample, head), repeated over the head's columns
            heads = m.reshape(steps, rows, 8, d // 8)
            assert torch.equal(heads, heads[..., :1].expand_as(heads)), f"mask {j}: heads"
            draws_n = steps * rows * 8
        r = float((m > 0).float().mean())
        assert abs(r - (1 - rate)) <= 5 * (rate * (1 - rate) / draws_n) ** 0.5, (j, r)
        rates.append(round(r, 4))
        flat = m.reshape(steps, -1)
        same = (flat[:, None] == flat[None]).all(dim=-1)
        assert int(same.sum()) == steps, f"mask {j}: two steps share a mask"
    print(f"[train_epoch] draws of one epoch ({n} samples): t mean {t_mean:.1f} var {t_var:.0f} "
          f"(uniform: {(n_steps - 1) / 2}, {var_u:.0f}); eps mean {e_mean:.5f} var {e_var:.5f} "
          f"max |eps| {float(eps.abs().max()):.2f}; cond keep rate {k_rate:.4f}; mask keep "
          f"rates {rates}; all inside five standard errors, mask values 0 or 1/(1-rate), "
          f"attention masks constant over a head, no two steps share a mask")


def epoch_counts(named, batch, steps, bf16_moments):
    """(bytes, flops) an epoch must move and do: a step, the train step's
    (`train_step_counts`) plus w, m and v read once and written once; nothing
    holds ~31 MB each of them on the chip between two steps."""
    step_bytes, step_flops = train_step_counts(named, batch)
    n = sum(v.numel() for v in named.values())
    opt = 2 * n * (4 + 2 * (2 if bf16_moments else 4))
    return steps * (step_bytes + opt), steps * step_flops, opt


def phase_train_epoch(vae, stats, pool, dataset):
    """The whole-epoch train kernel at flagship width, S = 15 steps of B = 64."""
    dev = torch.device("cuda")
    steps, batch = EPOCH_STEPS, TRAIN_BATCH
    row = {"name": "train_epoch", "route": "cuda",
           "source": "src/flowerdiff_torch/kernels/csrc/train_epoch.cu",
           "replaces": "src/flowerdiff/kernels/train_epoch.py:91",
           "max_abs_err": 0.0, "library_ms": None}
    gen = torch.Generator(device=dev).manual_seed(21)
    z_all, labels_all = _gather_rows(pool, dataset, 5, 12, gen)
    z_rows, labels = z_all[:steps], labels_all[:steps]
    hard = LatentDiffusionConfig(**{**FLAGSHIP, **TRAIN, **EPOCH_HARD})
    trainers = {k: LatentDiffusionTrainer(hard, vae, seed=6, latent_stats=stats)
                for k in ("kernel", "twin")}
    ks, ts_ = trainers["kernel"].state, trainers["twin"].state
    model, sched = trainers["kernel"].model, trainers["kernel"].sched

    # the start: 15 steps in, with moments of unclipped gradients
    warm = dataclasses.replace(hard, grad_clip=1e9)
    te.make_mega_epoch_fn(model, warm, steps, batch, dtype=torch.float32)(
        ks, sched, z_rows, labels, 31)
    torch.cuda.synchronize()
    start = _state_snapshot(ks)
    assert ks.step == steps
    tables = te.epoch_tables(ks.schedule, ks.step, steps)
    sum_lr = float(tables[0].sum())
    assert tables[0].max() > 5 * tables[0].min() and tables[2].max() < 0.05
    seed = 77
    draws = te.epoch_draws(model, hard, sched, steps, batch, seed, ks.step)
    _check_draws(draws, sched.n_steps, hard.dropout_rate, hard.cond_dropout)
    other = te.epoch_draws(model, hard, sched, steps, batch, seed + 1, ks.step)
    assert not torch.equal(other[1], draws[1]) and not torch.equal(other[3][0], draws[3][0])

    failures = []
    for lane, moments in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)):
        tag = (f"{'f32' if lane == torch.float32 else 'bf16'} lane, "
               f"{'f32' if moments == torch.float32 else 'bf16'} moments")
        _state_restore(ts_, start)
        ref_losses, ref_gnorms = te.mega_epoch_plain(ts_, sched, z_rows, labels, draws,
                                                     dtype=lane, moments_dtype=moments)
        injected = te.make_mega_epoch_fn(model, hard, steps, batch, dtype=lane,
                                         stochastic=False, moments_dtype=moments)
        _state_restore(ks, start)
        losses = injected(ks, sched, z_rows, labels, draws=draws)
        torch.cuda.synchronize()
        assert injected.launches == 1 and injected.steps == steps and ks.step == 2 * steps
        assert torch.isfinite(losses).all()
        f32, bf16, w_max = _epoch_readings(losses, ks, ref_losses, ts_, sum_lr)
        readings = f32 if lane == torch.float32 else bf16
        if lane == torch.float32 and moments == torch.bfloat16:
            # f32 products: the f32 limits hold, but stored moments may land a bf16 ulp apart
            readings = dict(f32, mu=bf16["mu"], nu=bf16["nu"])
        after_injected = _state_snapshot(ks)
        # the stochastic lane draws the same bits itself: the same epoch, bit for bit
        drawing = te.make_mega_epoch_fn(model, hard, steps, batch, dtype=lane,
                                        moments_dtype=moments)
        again = []
        for s in (seed, seed, seed + 1):
            _state_restore(ks, start)
            again.append((drawing(ks, sched, z_rows, labels, s).clone(), _state_snapshot(ks)))
        torch.cuda.synchronize()
        assert drawing.launches == 3
        same_bits = all(torch.equal(a, b) for a, b in zip(
            [losses] + after_injected[0][0], [again[0][0]] + again[0][1][0][0]))
        rerun_bits = all(torch.equal(a, b) for a, b in zip(
            [again[0][0]] + again[0][1][0][0] + again[0][1][0][1],
            [again[1][0]] + again[1][1][0][0] + again[1][1][0][1]))
        other_seed = not torch.equal(again[0][0], again[2][0])
        worst = max(readings, key=readings.get)
        print(f"[train_epoch] {tag}: losses {float(losses[0]):.5f} .. {float(losses[-1]):.5f} "
              f"(twin {float(ref_losses[0]):.5f} .. {float(ref_losses[-1]):.5f}); gradient norm "
              f"{float(injected.gnorms.min()):.3f} .. {float(injected.gnorms.max()):.3f} "
              f"(twin {float(ref_gnorms.min()):.3f} .. {float(ref_gnorms.max()):.3f}, clip "
              f"{hard.grad_clip}); in units of the limits "
              f"{ {k: round(v, 4) for k, v in readings.items()} }; max |dw| {w_max:.3e}; "
              f"stochastic lane equals the injected lane bit for bit: {same_bits}; same seed "
              f"twice bit-equal: {rerun_bits}; another seed differs: {other_seed}")
        if float(injected.gnorms.min()) <= 2 * hard.grad_clip:
            failures.append(f"{tag}: the clip does not bind")
        if readings[worst] > 1.0:
            failures.append(f"{tag}: {worst} at {readings[worst]:.3f} of its limit")
        if not (same_bits and rerun_bits and other_seed):
            failures.append(f"{tag}: bits {same_bits} {rerun_bits} {other_seed}")
        if lane == torch.bfloat16 and moments == torch.bfloat16:
            row["max_abs_err"] = w_max
            row["max_rel_err"] = bf16["mu"] * EPOCH_BF16_MOMENT_REL
    assert not failures, failures

    # that the limits mean something: a twin epoch without one term, against
    # the twin epoch with it (f32 lane, f32 moments), in units of both limits
    def twin_epoch(cfg=None, tables_=None):
        _state_restore(ts_, start)
        out = te.mega_epoch_plain(ts_, sched, z_rows, labels, draws, dtype=torch.float32,
                                  cfg=cfg, tables=tables_)[0]
        return out, types.SimpleNamespace(
            names=ts_.names, ema=None, **{k: [t.clone() for t in getattr(ts_, k)]
                                          for k in ("params", "mu", "nu")})

    ref_losses, ref = twin_epoch()
    ones = np.ones(steps, np.float32)
    variants = {
        "the clip": dict(cfg=dataclasses.replace(hard, grad_clip=float("inf"))),
        "the decay": dict(cfg=dataclasses.replace(hard, weight_decay=0.0)),
        "the bias corrections": dict(tables_=np.stack([tables[0], ones, ones])),
        "the falling lr": dict(tables_=np.stack([ones * tables[0, 0], tables[1], tables[2]])),
    }
    moves = {}
    for what, kw in variants.items():
        v_losses, got = twin_epoch(**kw)
        f32, bf16, _ = _epoch_readings(v_losses, got, ref_losses, ref, sum_lr)
        f32.pop("q, k"), bf16.pop("q, k"), bf16.pop("w max")
        moves[what] = (max(f32.values()), max(bf16.values()))
    # without the q/k decay q and k stay where they started
    qk = [j for j, n in enumerate(ref.names) if ".q." in n or ".k." in n]
    qk_move = _over([start[0][0][j] for j in qk], [ref.params[j] for j in qk], EPOCH_QK_RTOL, 0.0)
    moves["the q/k decay"] = (qk_move, qk_move)
    print(f"[train_epoch] a twin epoch without one term, in units of the (f32, bf16) limits: "
          f"{ {k: (round(a, 2), round(b, 2)) for k, (a, b) in moves.items()} }")
    weakest = min(moves, key=lambda k: min(moves[k]))
    assert min(moves[weakest]) > 2.0, (
        f"leaving out {weakest} moves the twin only {moves[weakest]} of the limits")

    # the main path: 10 stochastic epochs at the flagship recipe, then sampling
    cfg = LatentDiffusionConfig(**FLAGSHIP, **TRAIN)
    trainer = LatentDiffusionTrainer(cfg, vae, seed=4, latent_stats=stats)
    epoch_fn = te.make_mega_epoch_fn(trainer.model, cfg, steps, batch)  # bf16, bf16 moments
    epochs = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_bind = ts.tensor_map_encodes()
    losses = []
    for e in range(epochs):
        losses.append(epoch_fn(trainer.state, trainer.sched, z_all[e * steps:(e + 1) * steps],
                               labels_all[e * steps:(e + 1) * steps], 12))
        if e == 0:  # the first epoch binds the step: its maps are encoded then
            e_first = ts.tensor_map_encodes()
    losses = torch.stack(losses).cpu().numpy()
    dt = time.perf_counter() - t0
    e_later = ts.tensor_map_encodes() - e_first
    print(f"[train_epoch] tensor-map encodes: the first epoch (binding) {e_first - e_bind}, "
          f"an epoch after it {e_later / (epochs - 1):.1f}")
    assert e_later == 0, f"{e_later} tensor-map encodes in {epochs - 1} bound epochs"
    means = losses.mean(axis=1)
    assert np.all(np.isfinite(losses)) and means[-1] < means[0], means
    assert trainer.state.step == epochs * steps
    assert epoch_fn.launches == epochs and epoch_fn.steps == epochs * steps
    live = dict(zip(trainer.state.names, trainer.state.params))
    ema = trainer.sampling_params
    assert any(not torch.equal(ema[k], live[k]) for k in live), "EMA equals the live weights"
    row["launches"] = epoch_fn.launches
    print(f"[train_epoch] main path: {epochs} stochastic epochs x {steps} steps (bf16 lane, bf16 "
          f"moments, EMA {cfg.ema_decay}) in {dt * 1e3:.1f} ms; epoch launches "
          f"{epoch_fn.launches}, train steps enqueued {epoch_fn.steps}; epoch losses "
          f"{[round(float(v), 4) for v in means]}")
    reset_counts()
    sampler = trainer.sampler(fused=True)
    cls = torch.arange(16, device=dev) % FLAGSHIP["num_classes"]
    z = sampler.sample(16, cls, generator=torch.Generator(device=dev).manual_seed(13))
    with torch.no_grad():
        imgs = vae.decode(z)
    torch.cuda.synchronize()
    n_t = trainer.sched.n_steps
    assert z.shape == (16, FLAGSHIP["latent_dim"]) and torch.isfinite(z).all()
    assert imgs.shape == (16, 64, 64, 3) and torch.isfinite(imgs).all()
    assert launch_counts() == sampler_counts(1), launch_counts()
    assert len(bound_plans(sampler)) == 1
    print(f"[train_epoch] sampler(fused=True) on the EMA weights: 16 images, {n_t} guided "
          f"steps + decode; launches {launch_counts()}")

    # times: the epoch kernel beside the per-step kernel body, same shapes,
    # in the order body, epoch, epoch, body
    body_cfg = dataclasses.replace(cfg, train_kernel=True)
    body_trainer = LatentDiffusionTrainer(body_cfg, vae, seed=4, latent_stats=stats)
    body = make_fused_cached_epochs(body_trainer.model, body_cfg, steps_per_epoch=steps)
    idx = torch.from_numpy(epoch_rows(9, dataset.n, batch, 5)[0]).to(dev)
    bgen = torch.Generator(device=dev).manual_seed(15)

    def run_body():
        return body(body_trainer.state, body_trainer.sched, pool, dataset.labels, None, idx, bgen)

    def run_epochs():
        return [epoch_fn(trainer.state, trainer.sched, z_all[e * steps:(e + 1) * steps],
                         labels_all[e * steps:(e + 1) * steps], 12) for e in range(5)]

    def timed(fn):
        torch.cuda.synchronize()
        start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start_ev.record()
        fn()
        end_ev.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 5, start_ev.elapsed_time(end_ev) / 5

    run_body()
    walls = {"body": [], "epoch": []}
    events = {"body": [], "epoch": []}
    e_timed = ts.tensor_map_encodes()
    for which in ("body", "epoch", "epoch", "body"):
        wall, ev = timed(run_body if which == "body" else run_epochs)
        walls[which].append(wall)
        events[which].append(ev)
    e_timed = ts.tensor_map_encodes() - e_timed
    print(f"[train_epoch] tensor-map encodes over the timed runs (10 epochs, 10 epochs of the "
          f"per-step body): {e_timed}")
    assert e_timed == 0, f"{e_timed} tensor-map encodes in bound epochs and steps"
    # the same epoch with f32 moments (AdamW moves 4 more bytes a weight each way)
    epoch_f32m = te.make_mega_epoch_fn(trainer.model, cfg, steps, batch,
                                       moments_dtype=torch.float32)
    f32m_ms = [timed(lambda: [epoch_f32m(trainer.state, trainer.sched, z_all[:steps],
                                         labels_all[:steps], 12) for _ in range(5)])[1]
               for _ in range(2)][1]
    wall_prof, kernels = device_profile(lambda: epoch_fn(
        trainer.state, trainer.sched, z_all[:steps], labels_all[:steps], 12))
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    named = dict(ts.weights_spec(trainer.model))
    n_bytes, flops, opt_bytes = epoch_counts(named, batch, steps, bf16_moments=True)
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    ep_ms = float(np.mean(events["epoch"]))
    print(f"[train_epoch] an epoch of {steps} steps, B={batch}, bf16 lane, bf16 moments: "
          f"{ep_ms:.3f} ms between CUDA events ({ep_ms / steps:.4f} ms a step; runs "
          f"{[round(v, 3) for v in events['epoch']]}), wall {np.mean(walls['epoch']):.3f} ms "
          f"({np.mean(walls['epoch']) / steps:.4f} ms a step; runs "
          f"{[round(v, 3) for v in walls['epoch']]}); with f32 moments {f32m_ms:.3f} ms "
          f"between CUDA events; the per-step kernel body "
          f"(make_fused_cached_epochs) in the same call: wall "
          f"{np.mean(walls['body']):.3f} ms an epoch ({np.mean(walls['body']) / steps:.4f} ms "
          f"a step; runs {[round(v, 3) for v in walls['body']]}); bound {b_ms:.5f} ms an "
          f"epoch ({b_by}: {n_bytes / 1e6:.2f} MB, of which the optimizer's w, m, v in and "
          f"out {opt_bytes / 1e6:.2f} MB a step; {flops / 1e9:.3f} GFLOP)")
    print(f"[train_epoch] one profiled epoch: wall {wall_prof * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / steps:.4f} ms a step), idle share "
          f"{1 - busy / 1e3 / wall_prof:.3f}, {n_launch} launches")
    own = ("draws_kernel", "sumsq_kernel", "norm_kernel", "adamw_kernel", "moments_cast_kernel",
           "blend_kernel", "sched_kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        if any(k in e.key for k in own):
            print(f"[train_epoch]   {e.self_device_time_total / e.count:8.1f} us x{e.count:<4d} "
                  f"{e.key[:80]}")
    step_us = sum(e.self_device_time_total for e in kernels
                  if not any(k in e.key for k in own) and "Memcpy" not in e.key)
    print(f"[train_epoch]   the train step's kernels: {step_us / steps:.1f} us a step")

    # the twin's epoch, eager (autograd, ~600 ops a step: the host sets its time)
    _state_restore(ts_, start)
    twin_ms = timed(lambda: te.mega_epoch_plain(ts_, sched, z_rows, labels, draws))[1] * 5
    sums = product_sums()
    lib_ms = steps * sum(agg["library_us"] for agg in sums.values()) / 1e3
    for form, agg in sums.items():
        print(f"[train_epoch] bf16 {form} products of an epoch: {steps * agg['launches']} "
              f"launches, {steps * agg['us']:.1f} us alone; torch.matmul bf16 "
              f"{steps * agg['library_us']:.1f} us")
    print(f"[train_epoch] library_ms (one bf16 torch.matmul a product, {steps} steps) "
          f"{lib_ms:.4f}")
    row.update(ms=ep_ms, plain_ms=twin_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               ms_a_step=ep_ms / steps, f32_moments_ms=f32m_ms,
               wall_ms=float(np.mean(walls["epoch"])), busy_ms=busy,
               per_step_body_wall_ms=float(np.mean(walls["body"])),
               encodes_an_epoch_after_bind=e_later / (epochs - 1))
    print(f"[train_epoch] the twin's epoch, eager: {twin_ms:.1f} ms")
    row["deep"] = deep_train_epoch()
    return row


def deep_train_epoch() -> dict:
    """The epoch kernel over the 40-stage net of DEEP_TRAIN (its draws in
    more than one launch a step; a residual stream from the trainer's
    initial tree: the plain tree's drift is chaos, tools/depth_probe.py
    --epoch), S = EPOCH_STEPS steps of B = 64 in the f32 lane with f32
    moments, against the twin epoch on the draws the kernel makes, in units
    of the flagship epoch's f32 limits (`_epoch_readings`: losses, weights,
    moments, q and k); the epoch timed between CUDA events."""
    steps, batch, seed = EPOCH_STEPS, TRAIN_BATCH, 7
    cfg = LatentDiffusionConfig(**{**DEEP_TRAIN, "n_steps": 1000, "steps_per_epoch": steps,
                                   "dropout_rate": 0.3, "cond_dropout": 0.25})
    tree = init_numpy_params("denoiser", seed=3, bias_std=0.0, **DEEP_TRAIN)
    params = residual_stream(tree)
    gen = torch.Generator(device="cuda").manual_seed(23)
    z = torch.randn((steps, batch, cfg.latent_dim), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (steps, batch), generator=gen, device="cuda")
    runs = {}
    for kind in ("kernel", "twin"):
        state, model, sched = create_latent_diffusion_state(3, cfg, device="cuda", params=params)
        if kind == "kernel":
            fn = te.make_mega_epoch_fn(model, cfg, steps, batch, dtype=torch.float32,
                                       moments_dtype=torch.float32)
            losses = fn(state, sched, z, labels, seed)
            assert fn.launches == 1
        else:
            draws = te.epoch_draws(model, cfg, sched, steps, batch, seed, 0)
            losses, _ = te.mega_epoch_plain(state, sched, z, labels, draws, dtype=torch.float32,
                                            moments_dtype=torch.float32)
        torch.cuda.synchronize()
        runs[kind] = (losses, state)
    (lk, sk), (lt, st) = runs["kernel"], runs["twin"]
    assert torch.isfinite(lk).all()
    sum_lr = float(te.epoch_tables(st.schedule, 0, steps)[0].sum())
    readings = _epoch_readings(lk, sk, lt, st, sum_lr)[0]
    worst = max(readings, key=readings.get)
    state, model, sched = create_latent_diffusion_state(3, cfg, device="cuda", params=params)
    fn = te.make_mega_epoch_fn(model, cfg, steps, batch, dtype=torch.float32,
                               moments_dtype=torch.float32)
    ms = [event_ms(lambda: fn(state, sched, z, labels, seed), 1) for _ in range(2)]
    n_bytes, flops, _ = epoch_counts(dict(ts.weights_spec(model)), batch, steps, False)
    b_ms, b_by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
    print(f"[train_epoch] 40 stages of 128 (a residual stream, S={steps}), f32 lane: losses "
          f"{float(lk[0]):.5f} .. {float(lk[-1]):.5f} (twin {float(lt[0]):.5f} .. "
          f"{float(lt[-1]):.5f}); in units of the limits "
          f"{ {k: round(v, 4) for k, v in readings.items()} }; an epoch of {steps} steps "
          f"{np.mean(ms):.3f} ms between CUDA events (runs {[round(v, 3) for v in ms]}); bound "
          f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at the f32 "
          f"peak)")
    assert readings[worst] <= 1.0, f"deep epoch: {worst} at {readings[worst]:.3f} of its limit"
    return dict(ms=float(np.mean(ms)), readings=readings, bound_ms=b_ms, bound_by=b_by)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def kernel_launches() -> dict:
    """Every launch counter of the port's kernels."""
    return dict(launch_counts(), train_step=ts.kernel_loss_and_grads.launches,
                epoch_draws=te.epoch_draws.launches)


def _rms(t: torch.Tensor) -> float:
    return float(t.double().pow(2).mean().sqrt())


def vae_gan_step_counts(trainer, images, labels, gates):
    """(bytes, FLOP) of one VAE-GAN step: every weight of G and D with its two
    Adam moments read and written once, the frozen VGG read once, the images
    read once; the FLOP of its convolutions and products, forward and
    backward, as torch's FlopCounterMode counts them over one step."""
    from torch.utils.flop_counter import FlopCounterMode

    st = trainer.state
    n_bytes = sum(t.numel() * t.element_size() for t in st.tensors()) * 2
    n_bytes += sum(p.numel() * p.element_size() for p in trainer.vgg.parameters())
    n_bytes += images.numel() * images.element_size()
    with FlopCounterMode(display=False) as counter:
        trainer.step_fn(st, images, labels, gates, 99)
    return n_bytes, counter.get_total_flops()


def vae_gan_card_against_cpu(batches, gates, vgg, vgg_cpu, what):
    """Three f32 steps of the small-width VAE-GAN on the card and on the CPU
    from one seeded init, with the CPU's draws: prints, and returns, each
    loss's worst relative error, each leaf's readings as shares of their
    limits, and the centers' max error."""
    small = vg.VAEGANConfig(**VAE_GAN_SMALL)
    runs = {}
    draws = None
    init, _, _ = vg.create_vae_gan_state(5, small, device="cpu")
    for where, net in (("cpu", vgg_cpu), ("cuda", vgg)):
        state, vae, disc = vg.create_vae_gan_state(5, small, device=where)
        if draws is None:
            gen = torch.Generator().manual_seed(32)
            draws = [vg.draw_step_inputs(vae, len(batches[0][1]), gen, "cpu")
                     for _ in batches]
        body = vg.make_vae_gan_step_body(vae, disc, small, net)
        ms = []
        for (x, y), (eps, masks) in zip(batches, draws):
            m = body(state, x.to(where), y.to(where), gates.to(where),
                     draws=(eps.to(where), tuple(k.to(where) for k in masks)))
            ms.append({k: float(v) for k, v in m.items()})
        runs[where] = (ms, state)
    worst = {k: max(abs(g[k] - c[k]) / abs(c[k]) for g, c in zip(runs["cuda"][0], runs["cpu"][0]))
             for k in vg.METRICS}
    print(f"[vae_gan] card against CPU on {what}: {len(batches)} steps at channels "
          f"{small.channels}, latent {small.latent_dim}, B={len(batches[0][1])}, f32 (TF32 off), "
          "VGG from the asset, the CPU's draws: max relative error of each loss (limit "
          f"{VAE_GAN_LOSS_RTOL}): " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    w_max = 2 * max(small.lr, small.d_lr) * len(batches)  # Adam's largest move
    report = {}
    for part in ("gen", "disc"):
        got, ref = (getattr(runs[w][1], part) for w in ("cuda", "cpu"))
        for name, p, q, a, m, n in zip(ref.names, got.params, ref.params,
                                       getattr(init, part).params, got.mu, ref.mu):
            p, m = p.cpu(), m.cpu()
            if VAE_GAN_NOISE.search(name):
                report[(part, "noise", name)] = (
                    float((p - q).abs().max()) / w_max,
                    max(float(m.abs().max()), float(n.abs().max())) / VAE_GAN_NOISE_MU)
            else:
                report[(part, "leaf", name)] = (_rms(p - q) / _rms(q - a) / VAE_GAN_W_RTOL,
                                                _rms(m - n) / _rms(n) / VAE_GAN_MU_RTOL)
    for part, title in (("gen", "generator"), ("disc", "discriminator")):
        for kind, limits in (("leaf", f"weights (limit {VAE_GAN_W_RTOL} of the move) and first "
                                      f"moments (limit {VAE_GAN_MU_RTOL})"),
                             ("noise", f"rounding-noise leaves' weights (limit {w_max:.1e}) and "
                                       f"first moments (limit {VAE_GAN_NOISE_MU})")):
            got = {n: r for (p, k, n), r in report.items() if p == part and k == kind}
            if got:
                wn, mn = (max(got, key=lambda n, j=j: got[n][j]) for j in (0, 1))
                print(f"[vae_gan]   {title}, {len(got)} leaves, {limits}, each as a share of "
                      f"its limit: worst {got[wn][0]:.3f} ({wn}), {got[mn][1]:.3f} ({mn})")
    c_err = float((runs["cuda"][1].centers.cpu() - runs["cpu"][1].centers).abs().max())
    c_max = float(runs["cpu"][1].centers.abs().max())
    print(f"[vae_gan]   centers max abs error {c_err:.2e} of max|centers| {c_max:.3e} "
          f"(share {c_err / c_max:.2e})")
    return worst, report, c_err, c_max


def phase_vae_gan(dataset, model):
    """VAE-GAN training at the flagship VAE's full width: the card against
    the CPU at a small width, 2 fused epochs with the best-state policy in
    both lanes, bit-equal reruns, timings (host clock and CUDA events, the
    deterministic algorithms against cuDNN's default ones in turns, TF32),
    a profiled step, peak memory and the bound, then the trained generator
    through a latent pool and the service's decode."""
    dev = torch.device("cuda")
    card = card_line()
    gates = vg.gates_array(vae_gan_loss_gates(VAE_GAN_EPOCH, VAE_EPOCHS), dev)
    assert float(gates.min()) > 0, "not every gate is on"
    vgg = VGGPerceptual()
    vgg_cpu = VGGPerceptual(device="cpu")
    assert vgg.pretrained, "the VGG asset did not load"

    # --- the card against the CPU at a small width, the CPU's draws, f32
    rows = [torch.arange(i * 8, (i + 1) * 8) for i in range(3)]
    batches = [dataset.assemble(r.to(dev), derived_generator(dev, 31, i))
               for i, r in enumerate(rows)]
    flowers = [(x.cpu(), y.cpu()) for x, y in batches]
    noise_gen = torch.Generator().manual_seed(33)
    noise = [(torch.rand(x.shape, generator=noise_gen), y) for x, y in flowers]
    worst, report, c_err, _ = vae_gan_card_against_cpu(flowers, gates, vgg, vgg_cpu,
                                                       "augmented flower images")
    _, _, n_err, n_max = vae_gan_card_against_cpu(
        noise, gates, vgg, vgg_cpu, "uniform-noise images, only the centers gated")
    assert max(worst.values()) <= VAE_GAN_LOSS_RTOL, worst
    bad = {k: r for k, r in report.items() if max(r) > 1.0}
    assert not bad, bad
    assert c_err <= VAE_GAN_CENTER_ATOL, f"flowers: centers {c_err} > {VAE_GAN_CENTER_ATOL}"
    assert n_err <= VAE_GAN_NOISE_CENTER_REL * n_max, (
        f"noise: centers {n_err} > {VAE_GAN_NOISE_CENTER_REL} x max|centers| {n_max}")

    # --- the main path: 2 fused epochs at full width in each lane, best state tracked
    cfg = vg.VAEGANConfig(**VAE_GAN)
    steps = dataset.n // VAE_GAN_BATCH
    reset_counts()
    ts.kernel_loss_and_grads.launches = te.epoch_draws.launches = 0
    lanes = {}
    for lane in ("float32", "bfloat16"):
        trainer = vg.VAEGANTrainer(dataclasses.replace(cfg, compute_dtype=lane), seed=0, vgg=vgg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, (bl, bi, best) = trainer.run_epochs_fused(
            dataset, VAE_GAN_EPOCH, VAE_EPOCHS, 2, seed=1, batch_size=VAE_GAN_BATCH,
            best=(float("inf"), None))
        dt = (time.perf_counter() - t0) * 1e3
        means = [o["total"] for o in out]
        pick = int(np.argmin(means))
        print(f"[vae_gan] {lane}: run_epochs_fused, 2 epochs x {steps} steps of {VAE_GAN_BATCH} "
              f"augmented images at epoch {VAE_GAN_EPOCH} of {VAE_EPOCHS}, best state tracked: "
              f"{dt:.1f} ms ({dt / (2 * steps):.2f} ms a step, first calls included; {card}); "
              f"epoch means " + "; ".join(", ".join(f"{k} {o[k]:.4f}" for k in vg.METRICS)
                                          for o in out)
              + f"; best epoch {bi} (hand check: {VAE_GAN_EPOCH + pick}), best loss {bl:.5f}")
        assert all(np.isfinite(v) for o in out for v in o.values()), out
        assert bi == VAE_GAN_EPOCH + pick and abs(bl - means[pick]) <= 1e-5 * abs(means[pick])
        assert int(best.step) == steps * (pick + 1) and trainer.state.step == 2 * steps
        lanes[lane] = (trainer, out)
    counts = kernel_launches()
    print(f"[vae_gan] kernel launches over the VAE-GAN path (it runs none of the TPU "
          f"kernels' counterparts): {counts}")
    assert not any(counts.values()), counts
    band = {}
    for k in vg.METRICS:
        band[k] = max(abs(b[k] - f[k]) / abs(f[k])
                      for f, b in zip(lanes["float32"][1], lanes["bfloat16"][1]))
    print(f"[vae_gan] bf16 against f32, the same seed and draws, worst epoch mean (limit): "
          + ", ".join(f"{k} {band[k]:.2e}" for k in vg.METRICS) + f" ({VAE_GAN_BF16_BAND})")
    assert max(band.values()) <= VAE_GAN_BF16_BAND, band

    # --- two identical 3-step runs, bit for bit
    idx = torch.arange(3 * VAE_GAN_BATCH, device=dev).reshape(3, VAE_GAN_BATCH)
    batches = [dataset.assemble(r, derived_generator(dev, 41, i)) for i, r in enumerate(idx)]
    for lane in ("float32", "bfloat16"):
        finals = []
        for _ in range(2):
            lcfg = dataclasses.replace(cfg, compute_dtype=lane)
            state, vae, disc = vg.create_vae_gan_state(3, lcfg)
            step = vg.make_vae_gan_step(vae, disc, lcfg, vgg)
            ms = [step(state, x, y, gates, 42) for x, y in batches]
            finals.append((torch.stack([m[k] for m in ms for k in vg.METRICS]), state.tensors()))
            del vae, disc
        (m0, t0_), (m1, t1_) = finals
        n_diff = sum(int((a != b).sum()) for a, b in zip(t0_, t1_))
        n_all = sum(a.numel() for a in t0_)
        print(f"[vae_gan] {lane}: two identical 3-step runs from one seed: {n_diff} of {n_all} "
              f"state values and {int((m0 != m1).sum())} of {m0.numel()} losses differ")
        assert n_diff == 0 and torch.equal(m0, m1), "the VAE-GAN step is not bit-reproducible"
        del finals, t0_, t1_

    # --- timings: host clock and CUDA events, deterministic against default algorithms
    x, y = batches[0]

    def timed(trainer, n=10):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(n):
            trainer.step_fn(trainer.state, x, y, gates, (7, i))
        ev[1].record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, ev[0].elapsed_time(ev[1]) / n

    @contextlib.contextmanager
    def algorithms(which):
        # the step looks `deterministic_cudnn` up when it runs: the default
        # algorithms for the block
        if which == "deterministic":
            yield
            return
        keep = vg.deterministic_cudnn
        vg.deterministic_cudnn = contextlib.nullcontext
        try:
            yield
        finally:
            vg.deterministic_cudnn = keep

    @contextlib.contextmanager
    def tf32(on):
        keep = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep

    timing = {}
    for lane, trainer_lane, with_tf32 in (("f32", "float32", False),
                                          ("f32 + TF32", "float32", True),
                                          ("bf16", "bfloat16", False)):
        trainer = lanes[trainer_lane][0]
        res = {"deterministic": [], "default": []}
        with tf32(with_tf32):
            for which in res:  # each mode's first calls pick and plan its algorithms
                with algorithms(which):
                    timed(trainer, 2)
            for which in ("deterministic", "default", "default", "deterministic"):
                with algorithms(which):
                    res[which].append(timed(trainer))
        timing[lane] = res
        line = "; ".join(f"{w}: host {', '.join(f'{h:.2f}' for h, _ in r)} ms, events "
                         f"{', '.join(f'{e:.2f}' for _, e in r)} ms" for w, r in res.items())
        print(f"[vae_gan] {lane} step, B={VAE_GAN_BATCH}, 10 steps a turn, turns deterministic, "
              f"default, default, deterministic ({card}): {line}")

    # --- one profiled step, peak memory, the bound
    n_bytes, flops = vae_gan_step_counts(lanes["float32"][0], x, y, gates)
    for peak_name, peak in (("bf16", BF16_FLOP_PER_S), ("TF32", TF32_FLOP_PER_S),
                            ("f32", F32_FLOP_PER_S)):
        b_ms, b_by = bound_ms(n_bytes, flops, peak)
        timing[f"bound {peak_name}"] = (b_ms, b_by)
    print(f"[vae_gan] the step's work: {flops / 1e12:.4f} TFLOP (FlopCounterMode), "
          f"{n_bytes / 1e9:.3f} GB of weights, moments, VGG and images; bound "
          + ", ".join(f"{k[6:]} {v[0]:.3f} ms ({v[1]})" for k, v in timing.items()
                      if k.startswith("bound"))
          + f" ({card})")
    for lane, trainer_lane in (("f32", "float32"), ("bf16", "bfloat16")):
        trainer = lanes[trainer_lane][0]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer.step_fn(trainer.state, x, y, gates, 8)
        torch.cuda.synchronize()
        peak_mem = torch.cuda.max_memory_allocated()
        wall, kernels = device_profile(
            lambda: trainer.step_fn(trainer.state, x, y, gates, 9))
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        print(f"[vae_gan] {lane}, one profiled step: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy * 1e3:.2f} ms, idle share {1 - busy / wall:.3f}, "
              f"{sum(e.count for e in kernels)} kernels; peak memory {peak_mem / 2**30:.2f} GiB "
              f"({(peak_mem - resident) / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB "
              f"resident) ({card})")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[vae_gan]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
                  f"{e.key[:90]}")

    # --- the trained generator feeds the latent side: a pool, then a decode
    tree = state_dict_to_flax(lanes["float32"][0].vae)
    latent_vae = vae_from_params({"params": tree}, **VAE)
    assert latent_vae.classifier is None
    lcfg = LatentDiffusionConfig(**FLAGSHIP, latent_cache=1, encode_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool = make_latent_cache_builder(latent_vae, lcfg)(dataset.images,
                                                      torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    pool_ms = (time.perf_counter() - t0) * 1e3
    svc = SamplingService(model, latent_vae, sched=linear_schedule(1000), buckets=(8, 64))
    t0 = time.perf_counter()
    imgs = svc.decode_latents(pool[0, :8].cpu().numpy())
    dec_ms = (time.perf_counter() - t0) * 1e3
    assert pool.shape == (1, dataset.n, FLAGSHIP["latent_dim"]) and torch.isfinite(pool).all()
    assert imgs.shape == (8, 64, 64, 3) and np.isfinite(imgs).all()
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0
    print(f"[vae_gan] the trained f32 generator through the bridge into a FlowerVAE: a latent "
          f"pool of {dataset.n} augmented images in {pool_ms:.1f} ms (std "
          f"{float(pool.std()):.3f}), 8 of its latents decoded by SamplingService in "
          f"{dec_ms:.1f} ms (mean pixel {float(imgs.mean()):.3f}) ({card})")
    del lanes, pool


def pixel_step_counts(trainer, images):
    """(bytes, FLOP) of one pixel training step: the weights and both Adam
    moments read and written once, the images read once; the FLOP of the
    convolutions and products, forward and backward, as FlopCounterMode
    counts them over one step."""
    from torch.utils.flop_counter import FlopCounterMode

    n_bytes = sum(t.numel() * t.element_size() for t in trainer.state.tensors()) * 2
    n_bytes += images.numel() * images.element_size()
    with FlopCounterMode(display=False) as counter:
        trainer._step(trainer.state, images, 99)
    return n_bytes, counter.get_total_flops()


def pixel_card_against_cpu(dataset, card):
    """The PixelUNet (v5, base 16) on the card against the CPU from one
    seeded tree: the forward, then 3 Adam steps with the CPU's draws, each
    leaf of the weights and Adam first moments on its own."""
    small = px.PixelDiffusionConfig(**PIXEL_SMALL)
    tree = init_numpy_params("pixel", seed=7, **PIXEL_SMALL)
    gen = torch.Generator().manual_seed(21)
    x = torch.rand((8, 64, 64, 3), generator=gen) * 2 - 1
    t = torch.randint(0, small.n_steps, (8,), generator=gen)
    with torch.no_grad():
        out = {w: pixel_unet_from_params(tree, device=w, **PIXEL_SMALL)(x.to(w), t.to(w)).cpu()
               for w in ("cpu", "cuda")}
    scale = float(out["cpu"].abs().max())
    f_err = max_err(out["cuda"], out["cpu"]) / scale
    rows = torch.arange(24, device=dataset.images.device).reshape(3, 8)
    batches = [dataset.assemble(r, derived_generator(dataset.images.device, 23, i))[0].cpu()
               for i, r in enumerate(rows)]
    draws = [(torch.randint(0, small.n_steps, (8,), generator=gen),
              torch.randn((8, 64, 64, 3), generator=gen)) for _ in batches]
    runs = {}
    for where in ("cpu", "cuda"):
        state, model, sched = px.create_pixel_diffusion_state(0, small, device=where,
                                                              params=tree)
        body = px.make_pixel_diffusion_step_body(model)
        losses = [float(body(state, sched, b.to(where), draws=(tt.to(where), e.to(where))))
                  for b, (tt, e) in zip(batches, draws)]
        runs[where] = (losses, state)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    ref, got = runs["cpu"][1], runs["cuda"][1]
    init = dict(pixel_unet_from_params(tree, device="cpu", **PIXEL_SMALL).named_parameters())
    bound = 2 * small.lr * len(batches)  # Adam's largest move the other way
    shares, n_weak, n_all, dw_max = {}, 0, 0, 0.0
    for name, p, q, m, n in zip(ref.names, got.params, ref.params, got.mu, ref.mu):
        d, m = p.cpu() - q, m.cpu()
        g = n.abs() / (1 - 0.9 ** len(batches))
        strong = g >= PIXEL_GRAD_FLOOR * _rms(g)
        n_weak += int((~strong).sum())
        n_all += d.numel()
        dw_max = max(dw_max, float(d.abs().max()) / bound)
        w_share = _rms(d[strong]) / _rms(q - init[name].detach()) if strong.any() else 0.0
        shares[name] = (w_share / VAE_GAN_W_RTOL, _rms(m - n) / _rms(n) / VAE_GAN_MU_RTOL)
    wn, mn = (max(shares, key=lambda k, j=j: shares[k][j]) for j in (0, 1))
    print(f"[pixel] card against CPU at base 16 (v5), f32 (TF32 off): forward of 8 images, "
          f"max error {f_err:.2e} of max|CPU| {scale:.3f} (limit {PIXEL_FWD_RTOL}); 3 Adam "
          f"steps of B=8 with the CPU's draws: losses {runs['cuda'][0]} against "
          f"{runs['cpu'][0]}, worst relative {l_err:.2e} (limit {PIXEL_LOSS_RTOL}); "
          f"{len(shares)} leaves, as shares of their limits: weights of the elements whose "
          f"gradient is at least {PIXEL_GRAD_FLOOR} of its leaf's rms (limit {VAE_GAN_W_RTOL} "
          f"of the move) worst {shares[wn][0]:.3f} ({wn}), first moments (limit "
          f"{VAE_GAN_MU_RTOL}) worst {shares[mn][1]:.3f} ({mn}); {n_weak} of {n_all} weights "
          f"below the floor; largest |dw| {dw_max:.3f} of Adam's bound {bound:.1e} ({card})")
    assert f_err <= PIXEL_FWD_RTOL and l_err <= PIXEL_LOSS_RTOL
    bad = {k: r for k, r in shares.items() if max(r) > 1.0}
    assert not bad and dw_max <= 1.0, (bad, dw_max)


def phase_pixel(dataset):
    """The pixel family (v4/v5) at full width: the card against the CPU at
    base 16, then in each lane (f32 with TF32 off, bf16) 2 fused epochs of 15
    steps of 64, ms a step by CUDA events, a profiled step and the bound;
    PixelSamplingService at buckets (4, 16, 64): a 64-image request, a
    request that chunks, uint8 output, bit-equal identical requests, a
    50-step DDIM request; then a checkpoint of the full-width state saved,
    restored bit-equal, and one step from each equal. No kernel of the port
    runs here: every launch counter stays 0 over the phase."""
    dev = torch.device("cuda")
    card = card_line()
    pixel_card_against_cpu(dataset, card)

    cfg = px.PixelDiffusionConfig(learnable_residual=True)
    steps = dataset.n // PIXEL_BATCH
    reset_counts()
    ts.kernel_loss_and_grads.launches = te.epoch_draws.launches = 0
    x = dataset.assemble(torch.arange(PIXEL_BATCH, device=dev), derived_generator(dev, 51))[0]
    lanes = {}
    for lane in ("float32", "bfloat16"):
        trainer = px.PixelDiffusionTrainer(dataclasses.replace(cfg, compute_dtype=lane), seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means = trainer.run_epochs_fused(dataset, 2, seed=1, batch_size=PIXEL_BATCH)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        print(f"[pixel] {lane}: run_epochs_fused, 2 epochs x {steps} steps of {PIXEL_BATCH} "
              f"augmented images: {dt:.1f} ms ({dt / (2 * steps):.2f} ms a step, first calls "
              f"included; {card}); epoch means {means}; the steps' losses "
              + " ".join(f"{v:.6g}" for v in trainer.last_step_losses))
        assert np.isfinite(means).all() and means[1] <= 1.01 * means[0], means
        assert trainer.state.step == 2 * steps
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        trainer._step(trainer.state, x, (7, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(10):
            trainer._step(trainer.state, x, (7, i))
        ev[1].record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        step_ms = ev[0].elapsed_time(ev[1]) / 10
        wall, kernels = device_profile(lambda: trainer._step(trainer.state, x, 8))
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        print(f"[pixel] {lane} step, B={PIXEL_BATCH}: {step_ms:.2f} ms by CUDA events over 10 "
              f"steps ({host_ms:.2f} ms by host clock); one profiled step: wall "
              f"{wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, idle share "
              f"{1 - busy / wall:.3f}, {sum(e.count for e in kernels)} kernels ({card})")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"[pixel]   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
                  f"{e.key[:90]}")
        lanes[lane] = (trainer, means, step_ms)
    n_bytes, flops = pixel_step_counts(lanes["float32"][0], x)
    print(f"[pixel] the step's work: {flops / 1e12:.4f} TFLOP (FlopCounterMode), "
          f"{n_bytes / 1e9:.3f} GB of weights, moments and images; bound "
          + ", ".join(f"{name} {bound_ms(n_bytes, flops, peak)[0]:.3f} ms "
                      f"({bound_ms(n_bytes, flops, peak)[1]})"
                      for name, peak in (("bf16", BF16_FLOP_PER_S), ("TF32", TF32_FLOP_PER_S),
                                         ("f32", F32_FLOP_PER_S)))
          + f" ({card})")
    band = max(abs(b - f) / abs(f) for f, b in zip(lanes["float32"][1], lanes["bfloat16"][1]))
    f32_steps, bf16_steps = (lanes[k][0].last_step_losses for k in ("float32", "bfloat16"))
    print(f"[pixel] bf16 against f32, the same seed and draws: worst epoch mean {band:.2e} "
          f"(limit {PIXEL_BF16_BAND}); worst step "
          f"{float(np.max(np.abs(bf16_steps - f32_steps) / np.abs(f32_steps))):.2e}")
    assert band <= PIXEL_BF16_BAND

    # --- serving at buckets (4, 16, 64)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        lanes["float32"][0].model(x, torch.zeros(PIXEL_BATCH, dtype=torch.long, device=dev))
    step_flops = counter.get_total_flops()
    sched = lanes["float32"][0].sched
    for lane in ("float32", "bfloat16"):
        model = lanes[lane][0].sampling_model()
        svc = PixelSamplingService(model, sched, buckets=PIXEL_BUCKETS)
        assert svc.request_plan(64) == [64] and svc.request_plan(68) == [64, 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = svc.sample_images(64, seed=3)
        req_ms = (time.perf_counter() - t0) * 1e3
        assert imgs.shape == (64, 64, 64, 3) and imgs.dtype == np.float32
        assert np.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0
        short = DiffusionSampler(model, linear_schedule(20), (64, 64, 3), clip_x0=1.0)
        short_ms = event_ms(lambda: short.sample(PIXEL_BATCH, generator=derived_generator(
            dev, 5)), 2) / 20
        wall, kernels = device_profile(lambda: short.sample(
            PIXEL_BATCH, generator=derived_generator(dev, 6)))
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        peak = BF16_FLOP_PER_S if lane == "bfloat16" else F32_FLOP_PER_S
        b_ms, b_by = bound_ms(sum(p.numel() * p.element_size() for p in model.parameters())
                              + 2 * x.numel() * 4, step_flops, peak)
        print(f"[pixel] {lane} service: one 64-image request, {sched.n_steps} steps at the 64 "
              f"bucket: {req_ms:.1f} ms ({req_ms / sched.n_steps:.3f} ms a step, host clock); "
              f"a sampler step "
              f"at batch 64 by CUDA events {short_ms:.3f} ms; a profiled 20-step call: wall "
              f"{wall * 1e3 / 20:.3f} ms a step, device busy {busy * 1e3 / 20:.3f} ms, idle "
              f"share {1 - busy / wall:.3f}, {sum(e.count for e in kernels) // 20} kernels a "
              f"step; bound a step {b_ms:.3f} ms ({b_by}, {step_flops / 1e9:.1f} GFLOP) ({card})")
        if lane == "bfloat16":
            t0 = time.perf_counter()
            many = svc.sample_images(68, seed=4)
            chunk_ms = (time.perf_counter() - t0) * 1e3
            assert many.shape == (68, 64, 64, 3) and np.isfinite(many).all()
            u8 = PixelSamplingService(model, sched, buckets=PIXEL_BUCKETS, quantize_uint8=True)
            q = u8.sample_images(4, seed=7)
            a, b = svc.sample_images(4, seed=7), svc.sample_images(4, seed=7)
            ref = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
            n_diff = int((a != b).sum())
            print(f"[pixel] bf16 service: a 68-image request (chunks {svc.request_plan(68)}) "
                  f"{chunk_ms:.1f} ms; uint8 output of a 4-image request: {q.dtype}, range "
                  f"{q.min()}..{q.max()}, {int((q != ref).sum())} values off the float "
                  f"result quantised; two identical 4-image requests: {n_diff} values differ "
                  f"({card})")
            assert q.dtype == np.uint8 and q.shape == (4, 64, 64, 3) and q.max() > q.min()
            assert np.array_equal(q, ref), "uint8 output is not the float output quantised"
            assert n_diff == 0, "two identical pixel requests differ"
            assert not np.array_equal(a, svc.sample_images(4, seed=8))
        else:
            ddim = PixelSamplingService(model, sched, buckets=PIXEL_BUCKETS,
                                        sampler_kind="ddim", ddim_steps=50)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = ddim.sample_images(64, seed=3)
            ddim_ms = (time.perf_counter() - t0) * 1e3
            assert d.shape == (64, 64, 64, 3) and np.isfinite(d).all()
            assert d.min() >= 0.0 and d.max() <= 1.0
            print(f"[pixel] f32 DDIM service, 50 steps: one 64-image request {ddim_ms:.1f} ms "
                  f"(mean pixel {float(d.mean()):.3f}) ({card})")
    counts = kernel_launches()
    print(f"[pixel] kernel launches over the pixel path (it runs none of the TPU kernels' "
          f"counterparts): {counts}")
    assert not any(counts.values()), counts

    # --- checkpoint of the full-width state: restored bit-equal, one more step equal
    trainer = lanes["float32"][0]
    ckpt_dir = _ROOT / "build" / "pixel_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(ckpt_dir))
        t0 = time.perf_counter()
        mgr.save(trainer.state.step, state_to_tree(trainer.state))
        save_ms = (time.perf_counter() - t0) * 1e3
        state2, model2, sched2 = px.create_pixel_diffusion_state(
            1, dataclasses.replace(cfg, compute_dtype="float32"))
        t0 = time.perf_counter()
        tree_into_state(state2, mgr.restore(like=state_to_tree(state2)))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        size = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    at = trainer.state.step
    same = state2.step == at and all(
        torch.equal(a, b) for a, b in zip(trainer.state.tensors(), state2.tensors()))
    trainer._step(trainer.state, x, 77)
    px.make_pixel_diffusion_step(model2, sched2)(state2, x, 77)
    after = all(torch.equal(a, b) for a, b in zip(trainer.state.tensors(), state2.tensors()))
    print(f"[pixel] checkpoint of the f32 state at step {at}: "
          f"{size / 1e6:.1f} MB saved in {save_ms:.1f} ms, restored in {load_ms:.1f} ms; "
          f"restored state bit-equal: {same}; one more step from each bit-equal: {after} "
          f"({card})")
    assert same and after, "the restored pixel state does not continue as the unbroken one"
    return {lane: v[2] for lane, v in lanes.items()}


# The runner's command lines (phase_runner): the flagship preset at full
# width, depth cut to 2 VAE-GAN and 3 latent-DDPM epochs of 15 steps of 64
# over 1020 synthetic images; the v5 preset for 2 epochs.
RUNNER_FLAGSHIP = ["--version", "flagship", "--dataset", "synthetic", "--synthetic_size",
                   "1020", "--train_kernel", "--vae_epochs", "2", "--total_epochs", "3",
                   "--batch_size", "64"]
RUNNER_PIXEL = ["--version", "v5", "--dataset", "synthetic", "--synthetic_size", "1020",
                "--total_epochs", "2", "--batch_size", "64"]
RUNNER_TRAIN_STEPS = 3 * (1020 // 64)

# phase_http: (used, skipped, approximated) of the v1 import of each model
# written by the exporters (tests/test_torch_port_import.py pins the same
# counts on the CPU): the VAE's 130 tensors and its two center buffers; the
# discriminator's 16 tensors, BN's 9 running statistics skipped and its 3
# affines approximated (onto GroupNorm); the denoiser's 76 tensors and its 6
# dead-tail tensors skipped.
IMPORT_COUNTS = {"autoencoder": (132, 0, 0), "discriminator": (16, 9, 6), "denoiser": (76, 6, 0)}
RUNNER_FILES = ("ckpt_vae/step_*", "ckpt_diffusion/step_*", "latent_stats.npz",
                "vae_history.jsonl")
RUNNER_VIZ_FILES = ("vae_samples_grid_subset.png", "denoising_path_*_final.png",
                    "diffusion_animation_*_final.gif", "sample_quality.jsonl")


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to the real stdout."""

    def __init__(self, out):
        super().__init__()
        self._out = out

    def write(self, text):
        self._out.write(text)
        return super().write(text)


def run_cli(argv):
    """cli.main(argv) in this process: (its printed lines, its wall time s)."""
    from flowerdiff_torch import cli

    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        runner = cli.main(argv)
    torch.cuda.synchronize()
    return runner, tee.getvalue(), time.perf_counter() - t0


def stage_lines(text: str) -> dict:
    """{stage: seconds} of the runner's `[stage name] T s total` lines."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^\[stage (\S+)\] ([0-9.]+)s total", text, re.M)}


def _need_files(run_dir: Path, patterns) -> None:
    for pattern in patterns:
        found = sorted(p.name for p in run_dir.glob(pattern))
        assert found, f"{run_dir.name} holds nothing named {pattern}"


def phase_runner():
    """The pipeline through its command line and its run directory (phase
    16 above). Returns the sampler and train-step kernels' launches over
    the training run and the served request, by counter name."""
    from flowerdiff_torch.runner import missing_packages
    from flowerdiff_torch.serving import pixel_service_from_run, service_from_run

    card = card_line()
    missing = missing_packages("matplotlib", "sklearn")
    figures = not missing
    no_viz = [] if figures else ["--no-cadence-viz", "--no-final-sweep"]
    if missing:
        print(f"[runner] {', '.join(missing)} not installed: the runs take "
              f"{' '.join(no_viz)}; the figures they skip are listed below")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_ROOT / "build") as tmp:
        flagship = Path(tmp) / "flagship"
        argv = RUNNER_FLAGSHIP + ["--results_dir", str(flagship)] + no_viz

        # --- 1. train: the train-step kernel once a step, nothing else
        reset_counts()
        ts.kernel_loss_and_grads.launches = te.epoch_draws.launches = 0
        runner, text, wall = run_cli(argv)
        counts = kernel_launches()
        stages = stage_lines(text)
        print(f"[runner] flagship run: {wall:.1f} s; stages {stages}; kernel launches "
              f"{counts} ({card})")
        assert counts["train_step"] == RUNNER_TRAIN_STEPS, counts
        assert not any(v for k, v in counts.items() if k != "train_step"), counts
        assert runner.preset.latent.train_kernel and runner.preset.latent.latent_cache == 8
        psnr = re.search(r"^VAE recon PSNR: (.*)$", text, re.M).group(1)
        losses = [float(v) for v in re.findall(r"Average Loss: ([0-9.eE+-]+)", text)]
        assert len(losses) == 3 and np.isfinite(losses).all(), losses
        runner_launches = {"train_step": counts["train_step"]}

        # --- 2. resume: nothing trains, the same VAE
        reset_counts()
        ts.kernel_loss_and_grads.launches = 0
        resumed, text2, wall2 = run_cli(argv + ([] if no_viz else ["--no-final-sweep"]))
        assert "Loading existing autoencoder" in text2, text2
        assert "Loaded diffusion model at epoch 3" in text2, text2
        psnr2 = re.search(r"^VAE recon PSNR: (.*)$", text2, re.M).group(1)
        print(f"[runner] resumed run: {wall2:.1f} s; stages {stage_lines(text2)}; recon PSNR "
              f"{psnr} then {psnr2}")
        assert psnr2 == psnr, (psnr, psnr2)
        assert not any(kernel_launches().values()), kernel_launches()

        # --- the final sweep's parts that need neither matplotlib nor sklearn
        if not figures:
            from flowerdiff_torch import viz

            _, diff = resumed.run_latent(total_epochs=3, final_sweep=False, cadence_viz=False,
                                         restore_scope="params")
            decode_fn, encode_mu_fn, _ = resumed._vae_fns(resumed._trained_vae)
            sampler = diff.sampler()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = resumed._quality_report(sampler, encode_mu_fn)
            torch.cuda.synchronize()
            q_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for class_idx in range(10):
                viz.create_diffusion_animation(
                    sampler, decode_fn, class_idx, resumed.class_names, fps=15,
                    save_path=str(flagship / f"diffusion_animation_{class_idx}_final.gif"))
            torch.cuda.synchronize()
            anim_s = time.perf_counter() - t0
            assert np.isfinite(report["latent_mmd"]), report
            print(f"[runner] final sweep without figures (plain f32 model, 1000 steps): "
                  f"quality report {q_s:.1f} s (accuracy {report['classifier_accuracy']:.3f}, "
                  f"MMD {report['latent_mmd']:.4f}, FD {report['perceptual_fd']:.1f}); 10 "
                  f"animations {anim_s:.1f} s; the sample grid and the 10 denoising paths "
                  f"need matplotlib and sklearn: not run ({card})")
            assert not any(kernel_launches().values()), kernel_launches()
            del diff, sampler

        # --- 3. serve the run directory through the kernel sampler
        t0 = time.perf_counter()
        svc = service_from_run(str(flagship), version="flagship", synthetic_size=1020,
                               guidance_scale=7.0, quantize_uint8=True)
        build_s = time.perf_counter() - t0
        assert svc.use_fused and svc.sampler._inner.guidance_scale == 7.0
        stats = np.load(flagship / "latent_stats.npz")
        assert np.array_equal(svc.sampler.mean.cpu().numpy(), stats["mean"])
        t0 = time.perf_counter()
        svc.warmup()
        warm_s = time.perf_counter() - t0
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = svc.sample_classes(range(10), 5, seed=0)
        req_ms = (time.perf_counter() - t0) * 1e3
        served = launch_counts()
        want = sampler_counts(len(svc.request_plan(50)))
        again = svc.sample_classes(range(10), 5, seed=0)
        print(f"[runner] service_from_run: built in {build_s:.1f} s, warmup of buckets "
              f"{svc.buckets} {warm_s:.1f} s; launches over the 50-image request {served}")
        print(f"[runner] 50-image request served from the run directory (1000 steps, CFG 7.0, "
              f"clip 3.0, decode, uint8): {req_ms:.1f} ms ({card})")
        assert served == want, (served, want)
        assert imgs.shape == (50, 64, 64, 3) and imgs.dtype == np.uint8, imgs.shape
        assert np.array_equal(imgs, again), "two identical requests from the run differ"
        runner_launches.update(served)
        gif = svc.animate(4, seed=1)
        assert gif[:6] == b"GIF89a", gif[:6]
        print(f"[runner] animate(4, seed=1): {len(gif)} bytes of GIF")
        del svc

        # --- 4. the pixel family through the command line and its service
        pixel = Path(tmp) / "pixel"
        reset_counts()
        ts.kernel_loss_and_grads.launches = 0
        _, text3, wall3 = run_cli(RUNNER_PIXEL + ["--results_dir", str(pixel)]
                                  + ([] if figures else ["--no-cadence-viz"]))
        assert not any(kernel_launches().values()), kernel_launches()
        px_losses = [float(v) for v in re.findall(r"Diffusion Epoch \d+/2, Loss: (\S+)", text3)]
        assert len(px_losses) == 2 and np.isfinite(px_losses).all(), px_losses
        psvc = pixel_service_from_run(str(pixel), version="v5")
        t0 = time.perf_counter()
        px_imgs = psvc.sample_images(4, seed=0)
        px_ms = (time.perf_counter() - t0) * 1e3
        assert px_imgs.shape == (4, 64, 64, 3) and np.isfinite(px_imgs).all()
        assert px_imgs.min() >= 0.0 and px_imgs.max() <= 1.0
        print(f"[runner] v5 run: {wall3:.1f} s, epoch losses {px_losses}; "
              f"pixel_service_from_run: a 4-image request {px_ms:.1f} ms ({card})")

        # --- 5. the artifacts of the reference's names
        _need_files(flagship, RUNNER_FILES)
        _need_files(pixel, ("ckpt_pixel/step_2", "diffusion_animation.gif"))
        if figures:
            _need_files(flagship, RUNNER_VIZ_FILES)
        else:
            _need_files(flagship, ("sample_quality.jsonl", "diffusion_animation_*_final.gif"))
        print(f"[runner] run directory: {sorted(p.name for p in flagship.iterdir())}; pixel: "
              f"{sorted(p.name for p in pixel.iterdir())}")
    print(f"[runner] phase wall time {time.perf_counter() - t_phase:.1f} s; flagship stages "
          + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items()) + f" ({card})")
    return runner_launches


# phase_http: serial requests of 2 rows; the burst of HTTP_CLIENTS threads of
# HTTP_PER_CLIENT requests of 2 rows; the server's base seed
HTTP_SERIAL = 16
HTTP_CLIENTS, HTTP_PER_CLIENT = 16, 4
HTTP_SEED = 1234


def _http(port: int, method: str, path: str, body=None):
    """One request on its own connection: (status, content type, body,
    seconds)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data, dt


def _same_tensors(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        torch.equal(torch.as_tensor(got[k]).cpu(), want[k].detach().cpu()) for k in want)


def _perturb_all(modules, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen))


def _dir_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 2**20


def phase_http():
    """A reference user's v1 checkpoint imported and served over loopback
    HTTP (phase 17 above). Returns the sampler kernels' launches over the
    HTTP traffic, by counter name."""
    from flowerdiff_torch.configs import get_preset
    from flowerdiff_torch.data.flowers102 import class_names
    from flowerdiff_torch.models import Discriminator64
    from flowerdiff_torch.serving_http import serve
    from flowerdiff_torch.tools import import_torch_checkpoint
    from flowerdiff_torch.tools import serve as serve_tool
    from flowerdiff_torch.utils.device import derived_seed
    from flowerdiff_torch.utils.torch_import import (
        export_autoencoder,
        export_discriminator,
        export_latent_denoiser,
    )
    from flowerdiff_torch.utils.weights import load_discriminator

    card = card_line()
    preset = get_preset("v1")
    vcfg, lcfg = preset.vae, preset.latent
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_ROOT / "build") as tmp:
        tmp = Path(tmp)
        # --- 1. the reference's two files, written by the exporters from
        # seeded port modules at v1's full width, then the import tool
        arch = dict(latent_dim=vcfg.latent_dim, channels=tuple(vcfg.channels),
                    head_width=vcfg.head_width, num_classes=vcfg.num_classes)
        gen_m = vae_from_params(init_numpy_params("generator", seed=31, **arch), device="cpu",
                                **arch)
        disc = load_discriminator(Discriminator64(device="cpu"),
                                  init_numpy_params("discriminator", seed=32))
        den_kw = dict(latent_dim=lcfg.latent_dim, hidden_dims=tuple(lcfg.hidden_dims),
                      time_emb_dim=lcfg.time_emb_dim, num_classes=lcfg.num_classes,
                      shared_cond_proj=lcfg.shared_cond_proj, global_skip=lcfg.global_skip)
        den = denoiser_from_params(init_numpy_params("denoiser", seed=33, **den_kw),
                                   device="cpu", **den_kw)
        _perturb_all((gen_m, disc, den), 34)  # norm affines off 1 and 0 too
        centers = torch.randn((vcfg.num_classes, vcfg.latent_dim),
                              generator=torch.Generator().manual_seed(35))
        ae_pt, den_pt = tmp / "flower_autoencoder.pt", tmp / "conditional_diffusion_final.pt"
        t0 = time.perf_counter()
        torch.save({"autoencoder": export_autoencoder(gen_m, centers).params,
                    "discriminator": export_discriminator(disc).params}, ae_pt)
        torch.save(export_latent_denoiser(den).params, den_pt)
        export_s = time.perf_counter() - t0
        pt_mb = (ae_pt.stat().st_size + den_pt.stat().st_size) / 2**20
        run = tmp / "run"
        t0 = time.perf_counter()
        results = import_torch_checkpoint.main(
            ["--preset", "v1", "--out", str(run), "--autoencoder", str(ae_pt),
             "--diffusion", str(den_pt)])
        import_s = time.perf_counter() - t0
        counts = {k: (len(r.used), len(r.skipped), len(r.approximated))
                  for k, r in results.items()}
        vae_ckpt = CheckpointManager(str(run / "ckpt_vae"))
        diff_ckpt = CheckpointManager(str(run / "ckpt_diffusion"))
        vae_tree, diff_tree = vae_ckpt.restore(), diff_ckpt.restore()
        same = {"generator": _same_tensors(vae_tree["gen"]["params"], gen_m.state_dict()),
                "discriminator (GroupNorm affines through BatchNorm's)":
                    _same_tensors(vae_tree["disc"]["params"], disc.state_dict()),
                "centers": torch.equal(vae_tree["centers"], centers),
                "denoiser": _same_tensors(diff_tree["params"], den.state_dict())}
        print(f"[http] export of the v1 generator, discriminator and denoiser to the "
              f"reference's two files: {export_s:.2f} s, {pt_mb:.1f} MB; import tool: "
              f"{import_s:.2f} s, run directory {_dir_mb(run):.1f} MB (steps "
              f"{vae_ckpt.latest_step()} and {diff_ckpt.latest_step()}); (used, skipped, "
              f"approximated) {counts}; bit-equal round trip {same} ({card})")
        assert counts == IMPORT_COUNTS, (counts, IMPORT_COUNTS)
        assert all(same.values()), same
        assert vae_ckpt.latest_step() == preset.vae_epochs
        assert diff_ckpt.latest_step() == preset.total_epochs
        del gen_m, disc, den, vae_tree, diff_tree

        # --- 2. the service from the run directory, as tools/serve.py builds it
        args = serve_tool.build_parser().parse_args(
            ["--results_dir", str(run), "--version", "v1", "--synthetic_size", "1020",
             "--host", "127.0.0.1", "--port", "0"])
        t0 = time.perf_counter()
        svc = serve_tool.build_service(args)
        build_s = time.perf_counter() - t0
        inner = svc.sampler._inner
        assert svc.use_fused and svc.quantize_uint8 and svc.device.type == "cuda"
        assert inner.guidance_scale is None and inner.clip_x0 == lcfg.clip_denoised
        assert svc.unwarmed() == list(svc.buckets)
        try:
            serve(svc, HTTP_SEED, host=args.host, port=args.port)
        except RuntimeError as exc:
            print(f"[http] serve before warmup: refused ({exc})")
        else:
            raise AssertionError("serve took a service with no kernel plan bound")
        t0 = time.perf_counter()
        serve_tool.warm(svc, args.seed + 99)
        warm_s = time.perf_counter() - t0
        assert sorted(k[0] for k in inner.process.bound) == list(svc.buckets) == [
            8, 16, 32, 64, 128, 256]
        assert svc.unwarmed() == []

        # the v1 model's kernel path against the plain f32 model at the
        # buckets the traffic and the ceiling call run (no CFG: a bucket's
        # rows are the bucket), on a short schedule as phase_short_parity
        short = linear_schedule(20)
        skw = dict(clip_x0=inner.clip_x0, guidance_scale=None, device="cuda")
        fused20 = FusedDiffusionSampler(svc.model, short, (lcfg.latent_dim,), **skw)
        plain20 = DiffusionSampler(svc.model, short, (lcfg.latent_dim,), **skw)
        pgen = torch.Generator(device="cuda").manual_seed(36)
        for b in HTTP_ROWS:
            cls = torch.arange(b, device="cuda") % lcfg.num_classes
            x0 = torch.randn((b, lcfg.latent_dim), generator=pgen, device="cuda")
            got = fused20.sample(b, cls, x_init=x0, stochastic=False)
            ref = plain20.sample(b, cls, x_init=x0, stochastic=False)
            err, scale = max_err(got, ref), float(ref.abs().max())
            print(f"[http] v1 kernel sampler vs f32 model, B={b}, T=20, no CFG, clip "
                  f"{inner.clip_x0}: max_abs_err {err:.4e} (max|ref| {scale:.3f}, tol "
                  f"{3e-2 * scale:.4e})")
            assert err <= 3e-2 * scale, f"B={b}: the v1 kernel sampler disagrees with the model"
        del fused20, plain20
        cls64 = np.arange(64) % lcfg.num_classes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.sample(cls64, seed=2)
        ceiling_s = time.perf_counter() - t0
        print(f"[http] service from the run directory: built in {build_s:.1f} s, warmup of "
              f"buckets {svc.buckets} {warm_s:.1f} s; device ceiling, one direct 64-row call: "
              f"{ceiling_s * 1e3:.1f} ms, {64 / ceiling_s:.1f} images/s ({card})")

        # --- 3. serve it over loopback HTTP, every dispatch recorded
        dispatches = []
        orig = svc.sample_async

        def spy(classes, seed=0, colors=None, decode=True, *rest, **kw):
            fetch = orig(classes, seed, colors, decode, *rest, **kw)
            entry = {"classes": np.array(classes), "seed": seed, "decode": decode}
            dispatches.append(entry)

            def recorded():
                entry["out"] = fetch()
                return entry["out"]

            return recorded

        svc.sample_async = spy
        server = serve(svc, HTTP_SEED, host=args.host, port=args.port,
                       max_wait_ms=args.max_wait_ms, max_batch=args.max_batch,
                       class_names=class_names())
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        replies, errors, anim = {}, [], {}

        def client(i):
            try:
                for j in range(HTTP_PER_CLIENT):
                    r = i * HTTP_PER_CLIENT + j
                    classes = [r % 102, (5 * r + 1) % 102]
                    replies[r] = (classes, _http(port, "POST", "/v1/sample",
                                                 {"classes": classes, "format": "npy"}))
            except Exception as exc:  # failed below
                errors.append(exc)

        try:
            status, _, data, _ = _http(port, "GET", "/healthz")
            health = json.loads(data)
            print(f"[http] GET /healthz: {status} {health}")
            assert status == 200 and health["backend"] == "cuda" and health["family"] == "latent"
            assert health["buckets"] == list(svc.buckets) and health["num_classes"] == 102
            bound = dict(inner.process.bound)
            reset_counts()
            serial = []
            t0 = time.perf_counter()
            for k in range(HTTP_SERIAL):
                classes = [k % 102, (7 * k + 3) % 102]
                reply = _http(port, "POST", "/v1/sample", {"classes": classes, "format": "npy"})
                assert reply[:2] == (200, "application/octet-stream"), reply[:2]
                serial.append((classes, np.load(io.BytesIO(reply[2])), reply[3]))
            serial_s = time.perf_counter() - t0
            assert len(dispatches) == HTTP_SERIAL
            threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
            threads.append(threading.Thread(target=lambda: anim.update(
                reply=_http(port, "POST", "/v1/animate", {"class": 4, "seed": 11}))))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads[:-1]:
                t.join(timeout=600)
            burst_s = time.perf_counter() - t0  # the clients' requests
            threads[-1].join(timeout=600)
            all_s = time.perf_counter() - t0  # and the animation
            launches = launch_counts()
            stats = json.loads(_http(port, "GET", "/stats")[2])
        finally:
            server.shutdown()
            server.server_close()
            server.batcher.stop()
            svc.sample_async = orig

        # --- 4. the gates
        assert not errors, errors
        assert dict(inner.process.bound) == bound, "a plan was bound under the traffic"
        assert not torch.backends.cudnn.deterministic, "two threads restored each other's flags"
        chunks = sum(len(svc.request_plan(len(d["classes"]))) for d in dispatches)
        want = sampler_counts(chunks)
        print(f"[http] launches over the traffic {launches}; expected {want} for {chunks} "
              f"bucket chunks ({len(dispatches)} service calls, the animation's included)")
        assert launches == want, (launches, want)
        for k, (classes, got, _) in enumerate(serial):
            d = dispatches[k]
            assert d["seed"] == derived_seed(HTTP_SEED, k) and list(d["classes"]) == classes
            ref = svc.sample(np.array(classes), derived_seed(HTTP_SEED, k))
            assert np.array_equal(got, ref.astype(np.float32) / 255.0), f"serial request {k}"
        burst = [d for d in dispatches[HTTP_SERIAL:] if d["decode"]]
        for d in dispatches[HTTP_SERIAL:]:
            ref = svc.sample(d["classes"], d["seed"], decode=d["decode"])
            assert np.array_equal(d["out"], ref), f"dispatch of {len(d['classes'])} rows"
        lat = []
        for r, (classes, (status, ctype, data, dt)) in sorted(replies.items()):
            assert status == 200, (r, status, data[:200])
            got = np.load(io.BytesIO(data))
            assert any(np.array_equal(got, d["out"][o:o + 2].astype(np.float32) / 255.0)
                       for d in burst for o in range(len(d["classes"]) - 1)
                       if list(d["classes"][o:o + 2]) == classes), f"burst request {r}"
            lat.append(dt)
        assert len(replies) == HTTP_CLIENTS * HTTP_PER_CLIENT
        status, ctype, gif, anim_dt = anim["reply"]
        assert status == 200 and ctype == "image/gif" and gif[:6] == b"GIF89a"
        assert gif == svc.animate(4, 11, label="4"), "the served animation differs"
        n_burst = 2 * HTTP_CLIENTS * HTTP_PER_CLIENT
        serial_lat = [v[2] for v in serial]
        print(f"[http] serial: {HTTP_SERIAL} requests of 2 rows in {serial_s:.2f} s, "
              f"{2 * HTTP_SERIAL / serial_s:.1f} images/s, latency p50 "
              f"{np.percentile(serial_lat, 50) * 1e3:.1f} ms p99 "
              f"{np.percentile(serial_lat, 99) * 1e3:.1f} ms; bit-equal to direct calls at "
              f"their derived seeds ({card})")
        print(f"[http] burst: {HTTP_CLIENTS} clients x {HTTP_PER_CLIENT} requests x 2 rows "
              f"in {burst_s:.2f} s, {n_burst / burst_s:.1f} images/s, beside one /v1/animate "
              f"(all done in {all_s:.2f} s); "
              f"{len(burst)} dispatches, max_coalesced {stats['max_coalesced']}, rows a "
              f"dispatch {[len(d['classes']) for d in burst]}; request latency p50 "
              f"{np.percentile(lat, 50) * 1e3:.1f} ms p99 {np.percentile(lat, 99) * 1e3:.1f} "
              f"ms; animation {anim_dt:.2f} s, {len(gif)} bytes, bit-equal to animate(); "
              f"every reply bit-equal to its dispatch called directly ({card})")
        print(f"[http] stats {stats}")
        del svc
    print(f"[http] phase wall time {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# phase_parallel: the three training chunks (the flagship VAE-GAN in f32,
# the uncached latent chunk, the v5 pixel chunk) on PARALLEL_IMAGES images,
# a global batch of 64: one epoch of 2 steps, then another one timed
PARALLEL_IMAGES, PARALLEL_BATCH = 128, 64
PARALLEL_LATENT = dict(dropout_rate=0.3, cond_dropout=0.1, ema_decay=0.999,
                       normalize_latents=True, steps_per_epoch=PARALLEL_IMAGES // PARALLEL_BATCH,
                       clip_denoised=CLIP, guidance_scale=GUIDANCE)
# world size 2 against world size 1: tests/test_fused.py's mesh tolerances
# for the losses (the VAE-GAN's total, the latent and pixel losses); the
# VAE-GAN's other terms within VAE_GAN_LOSS_RTOL, the card-against-CPU limit.
# The pixel losses (~1e6 at init, the raw-timestep scale) hold them over the
# first epoch, one Adam update from the common init (2.3e-6 on the H100);
# two updates later the elements whose gradient is rounding noise have
# stepped by ~lr either way, as between the card and the CPU (PERF.md
# section 6), and the second epoch read 1.3e-4: it is held to
# VAE_GAN_LOSS_RTOL.
PARALLEL_LOSS_RTOL, PARALLEL_LOSS_ATOL = 5e-5, 1e-6
# the tensor-parallel forward against the replicated one, relative to
# max|replicated| (tests/test_parallel.py's 2e-5 on values of order one)
PARALLEL_TP_REL = 2e-5
PARALLEL_TP_ROWS = 64
# the CLI at world size 1 on NCCL: the flagship preset (train-step kernel,
# latent cache) on 256 images, 1 VAE-GAN epoch and 2 latent epochs of 4 steps
RUNNER_PARALLEL = ["--version", "flagship", "--dataset", "synthetic", "--synthetic_size",
                   "256", "--train_kernel", "--vae_epochs", "1", "--total_epochs", "2",
                   "--batch_size", "64", "--mesh_data", "1", "--no-cadence-viz",
                   "--no-final-sweep"]
RUNNER_PARALLEL_STEPS = 2 * (256 // 64)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _timed_epochs(fn, steps):
    """fn() twice, an epoch each: the first untimed (cuDNN's and cuBLAS's
    first calls), the second timed by host clock. Returns ms a step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def parallel_chunks(images, labels, stats, mesh, vgg):
    """The three chunks from fixed seeds on `mesh` (None: no process
    group), two epochs each: {name: (per-epoch losses, state tensors, ms a
    step of the second epoch)}. The VAE-GAN's losses are its metrics,
    "total" first."""
    dataset = DeviceDataset(images, labels, mesh=mesh)
    steps = PARALLEL_IMAGES // PARALLEL_BATCH
    out = {}
    gan = vg.VAEGANTrainer(vg.VAEGANConfig(**VAE_GAN), seed=0, vgg=vgg)
    runs = []
    ms = _timed_epochs(lambda: runs.extend(gan.run_epochs_fused(
        dataset, VAE_GAN_EPOCH, VAE_EPOCHS, 1, seed=len(runs), batch_size=PARALLEL_BATCH,
        mesh=mesh)), steps)
    losses = [[m[k] for k in ("total",) + vg.METRICS[:-1]] for m in runs]
    out["vae_gan"] = (np.asarray(losses), gan.state.tensors(), ms)
    vae = vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cuda", **VAE)
    lat = LatentDiffusionTrainer(LatentDiffusionConfig(**FLAGSHIP, **PARALLEL_LATENT), vae,
                                 seed=4, latent_stats=stats)
    gen = torch.Generator(device="cuda").manual_seed(16)
    runs = []
    ms = _timed_epochs(lambda: runs.append(lat.run_epochs_fused(
        dataset, 1, None, gen, batch_size=PARALLEL_BATCH, mesh=mesh)), steps)
    out["latent"] = (np.asarray(runs), lat.state.tensors() + lat.state.ema, ms)
    pix = px.PixelDiffusionTrainer(px.PixelDiffusionConfig(learnable_residual=True), seed=0)
    runs = []
    ms = _timed_epochs(lambda: runs.append(pix.run_epochs_fused(
        dataset, 1, seed=len(runs), batch_size=PARALLEL_BATCH, mesh=mesh)), steps)
    out["pixel"] = (np.asarray(runs), pix.state.tensors(), ms)
    return out


def tensor_parallel_forward(mesh) -> dict:
    """The flagship denoiser's forward sharded over the mesh's "model" dim
    against the replicated forward, on PARALLEL_TP_ROWS rows: the error and
    ms of each (CUDA events over 20 calls)."""
    from flowerdiff_torch.parallel import latent_denoiser_rules, shard_params

    tree = init_numpy_params("denoiser", seed=0, **FLAGSHIP)
    replicated = denoiser_from_params(tree, device="cuda", **FLAGSHIP)
    sharded = shard_params(denoiser_from_params(tree, device="cuda", **FLAGSHIP), mesh,
                           latent_denoiser_rules())
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((PARALLEL_TP_ROWS, FLAGSHIP["latent_dim"]), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (PARALLEL_TP_ROWS,), generator=gen, device="cuda")
    c = torch.randint(0, FLAGSHIP["num_classes"], (PARALLEL_TP_ROWS,), generator=gen,
                      device="cuda")
    with torch.no_grad():
        ref, got = replicated(x, t, c), sharded(x, t, c)
        return {"rel_err": float((got - ref).abs().max() / ref.abs().max()),
                "local_block_fc_0": tuple(sharded.block_fc_0.weight.shape),
                "ms": event_ms(lambda: sharded(x, t, c), 20),
                "replicated_ms": event_ms(lambda: replicated(x, t, c), 20)}


def _parallel_rank(rank, workdir, payload):
    """One of phase_parallel's two ranks on the one card, over gloo: the
    three chunks at world size 2, then the tensor-parallel forward at
    model=2. Saves {chunk: (losses, digest of the state, ms a step), "tp":
    ...} for the parent."""
    import faulthandler

    faulthandler.enable()  # a crash in a collective prints the rank's stack
    from flowerdiff_torch.parallel import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
                            rank=rank, world_size=2)
    try:
        vgg = VGGPerceptual(device="cuda")
        chunks = parallel_chunks(*payload, create_mesh(device_type="cuda"), vgg)
        out = {k: (v[0], _digest(v[1]), v[2]) for k, v in chunks.items()}
        del chunks
        out["tp"] = tensor_parallel_forward(create_mesh(data=1, model=2, device_type="cuda"))
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_parallel(images, labels, stats):
    """phase 19 above. Returns the train-step kernel's launches in the CLI
    run, by counter name."""
    from flowerdiff_torch.parallel import create_mesh, init_distributed, mesh_size

    card = card_line()
    t_phase = time.perf_counter()
    images, labels = images[:PARALLEL_IMAGES], labels[:PARALLEL_IMAGES]
    vgg = VGGPerceptual(device="cuda")
    alone = parallel_chunks(images, labels, stats, None, vgg)

    # --- (a) world size 1 on NCCL, torchrun's environment for one rank
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    try:
        assert init_distributed() == 1 and dist.get_backend() == "nccl"
        mesh = create_mesh()
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        one = parallel_chunks(images, labels, stats, mesh, vgg)
        for name, (losses, tensors, ms) in one.items():
            ref_losses, ref_tensors, ref_ms = alone[name]
            same = np.array_equal(losses, ref_losses) and all(
                torch.equal(a, b) for a, b in zip(tensors, ref_tensors, strict=True))
            print(f"[parallel] {name}: NCCL world size 1 {ms:.2f} ms a step against "
                  f"{ref_ms:.2f} with no group (global batch {PARALLEL_BATCH}); losses and "
                  f"{len(tensors)} state tensors bit-equal: {same} ({card})")
            assert same, name
        del one
        reset_counts()
        ts.kernel_loss_and_grads.launches = te.epoch_draws.launches = 0
        with tempfile.TemporaryDirectory(dir=_ROOT / "build") as tmp:
            runner, text, wall = run_cli(RUNNER_PARALLEL + ["--results_dir", tmp])
        counts = kernel_launches()
        print(f"[parallel] cli.main --mesh_data 1 --train_kernel on NCCL: {wall:.1f} s, "
              f"kernel launches {counts} ({card})")
        assert mesh_size(runner.mesh) == 1 and runner.preset.latent.train_kernel
        assert counts["train_step"] == RUNNER_PARALLEL_STEPS, counts
        assert not any(v for k, v in counts.items() if k != "train_step"), counts
        losses = [float(v) for v in re.findall(r"Average Loss: ([0-9.eE+-]+)", text)]
        assert len(losses) == 2 and np.isfinite(losses).all(), losses
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in env:
            os.environ.pop(key, None)

    # --- (b), (c) world size 2 on the one card: two spawned ranks over gloo
    # (NCCL refuses two ranks on one device)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=_ROOT / "build") as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_parallel_rank, args=(tmp, (images, labels, stats)),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                assert time.perf_counter() - t0 < 400, "the two ranks are still running"
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        spawn_s = time.perf_counter() - t0
    def rel(a, b):
        return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)

    for name, (ref_losses, _tensors, ref_ms) in alone.items():
        (losses, digest, ms), (losses1, digest1, ms1) = ranks[0][name], ranks[1][name]
        err = rel(losses, ref_losses)
        print(f"[parallel] {name}: gloo world size 2 on one card {ms:.2f} / {ms1:.2f} ms a "
              f"step (rank 0 / 1, {PARALLEL_BATCH // 2} rows each) against {ref_ms:.2f} with "
              f"no group; losses against world size 1 by epoch: total or loss "
              f"{err[:, 0].tolist()}, every term {err.max():.2e}; ranks bit-equal: "
              f"{digest == digest1} ({card})")
        assert digest == digest1 and np.array_equal(losses, losses1), name
        late = VAE_GAN_LOSS_RTOL if name == "pixel" else PARALLEL_LOSS_RTOL
        for epoch, rtol in enumerate((PARALLEL_LOSS_RTOL, late)):
            np.testing.assert_allclose(losses[epoch, 0], ref_losses[epoch, 0], rtol=rtol,
                                       atol=PARALLEL_LOSS_ATOL, err_msg=f"{name} {epoch}")
        np.testing.assert_allclose(losses, ref_losses, rtol=VAE_GAN_LOSS_RTOL, err_msg=name)
    for rank in ranks:
        tp = rank["tp"]
        print(f"[parallel] tensor-parallel flagship denoiser at model=2 over gloo, "
              f"{PARALLEL_TP_ROWS} rows: {tp['ms']:.3f} ms against {tp['replicated_ms']:.3f} "
              f"replicated; error {tp['rel_err']:.2e} of max|replicated|; block_fc_0 local "
              f"{tp['local_block_fc_0']} ({card})")
        assert tp["rel_err"] <= PARALLEL_TP_REL, tp
        assert tp["local_block_fc_0"] == (FLAGSHIP["hidden_dims"][0] // 2,
                                          FLAGSHIP["hidden_dims"][0]), tp
    print(f"[parallel] two ranks: {spawn_s:.1f} s with their start; phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return {"train_step": counts["train_step"]}


def phase_ingest():
    """The one-time JPEG ingest: which decoder the card's machine has
    (the native libjpeg one, built here, or PIL, and why), and 64 JPEGs of
    500x375 decoded to 64x64 by each, timed."""
    from PIL import Image

    from flowerdiff_torch import native

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(dir=_ROOT / "build") as tmp:
        paths = []
        for i in range(64):
            path = os.path.join(tmp, f"image_{i:05d}.jpg")
            Image.fromarray(rng.integers(0, 255, (375, 500, 3), dtype=np.uint8)).save(path)
            paths.append(path)
        t0 = time.perf_counter()
        built = native.native_available()  # builds on first use
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        imgs, ok = native.decode_jpeg_batch(paths, 64)
        decode_ms = (time.perf_counter() - t0) * 1e3
        assert ok.all() and imgs.shape == (64, 64, 64, 3)
        used = (f"native libjpeg decoder (built in {build_s:.1f} s)" if built
                else f"PIL (the native decoder did not build in {build_s:.1f} s: "
                     f"{native.build_error()})")
        saved = native._load
        native._load = lambda: None
        try:
            t0 = time.perf_counter()
            pil, pil_ok = native.decode_jpeg_batch(paths, 64)
            pil_ms = (time.perf_counter() - t0) * 1e3
        finally:
            native._load = saved
        assert pil_ok.all()
        diff = int(np.abs(imgs.astype(np.int16) - pil.astype(np.int16)).max())
    print(f"[ingest] decoder: {used}; 64 JPEGs of 500x375 to 64x64: {decode_ms:.1f} ms, PIL "
          f"{pil_ms:.1f} ms (max |difference| {diff} of 255; host, {os.cpu_count()} cores)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    den_params = init_numpy_params("denoiser", seed=0, **FLAGSHIP)
    model = denoiser_from_params(den_params, device="cuda", **FLAGSHIP)
    vae = vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cuda", **VAE)
    sched = linear_schedule(1000)
    prep = prepare_fused_sampler(model, sched.to("cuda"))

    kernel_rows = phase_kernels(model, prep, gen)
    kernel_rows.append(phase_process(prep, gen))
    wide = phase_wide()
    phase_noise(sched)
    phase_short_parity(model, gen)
    phase_profile(model)
    stats = np.load(STATS)
    stats = (stats["mean"], stats["std"])
    launches, host, calls = phase_service(model, vae, stats)
    phase_tiny_service()
    for row in kernel_rows:
        if row["name"] == "reverse_process":  # kernel 3: the whole reverse process
            row["launches"] = launches[row["name"]]
            row["path"] = "phase_service: three requests, one launch a bucket call"
            row["bucket_call"] = {str(b): c for b, c in calls.items()}
            row["max_abs_err"] = max([row["max_abs_err"]] + [c["max_abs_err"]
                                                             for c in calls.values()])
        else:  # the step's own kernels: the host loop, the reverse process's oracle
            row["launches"] = host[row["name"]]
            row["path"] = "phase_service: the host loop (fused_sample), one 64-bucket call"
        # phase_wide: the lopsided nets past 4096 (counts from zero a run)
        row["wide_launches"] = wide["launches"].get(row["name"], 0)
        if row["name"] == "fused_head":
            row["wide_products_launches"] = wide["launches"]["fused_head_products"]
        for k, v in wide.get(row["name"], {}).items():
            row["wide_" + k if k == "max_abs_err" else k] = v
    phase_ddim(model, vae, stats, den_params)
    phase_partial(model)
    images, labels = synthetic_flowers(1020, FLAGSHIP["num_classes"], 64, seed=0)
    dataset = DeviceDataset(images, labels)  # augments: rotation 10 degrees, jitter 0.2
    phase_augment(dataset)
    train_row = phase_train_kernel(gen)
    train_row["launches"], pool = phase_train(vae, stats, dataset)
    train_row["uncached_launches"] = phase_uncached(vae, stats, dataset)
    kernel_rows.append(train_row)
    kernel_rows.append(phase_train_epoch(vae, stats, pool, dataset))
    del pool
    phase_vae_gan(dataset, model)
    phase_pixel(dataset)
    runner_launches = phase_runner()
    http_launches = phase_http()
    phase_ingest()
    parallel_launches = phase_parallel(images, labels, stats)
    for row in kernel_rows:
        row["runner_launches"] = runner_launches.get(row["name"], 0)
        row["http_launches"] = http_launches.get(row["name"], 0)
        row["parallel_launches"] = parallel_launches.get(row["name"], 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
