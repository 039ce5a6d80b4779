#!/usr/bin/env python3
"""Smoke run of the PyTorch port (imagegeneration_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):

1. Require a CUDA device; print the Python/torch/CUDA versions and the
   card's name and power limit.
2. Build the hand-written CUDA kernels from csrc/ (one nvcc per source, all
   started together; ctypes binding).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the headline steps, with times beside the least time the card could
   take (bytes over 3.35 TB/s, or operations over 67 TFLOP/s float32,
   whichever is larger) and, where one PyTorch call computes the same
   function, that call's time. A time is the device time of a call from
   CUDA events (tools/devtime.py), over back-to-back calls queued while
   the card waits; for the InstanceNorm kernels, whose inputs (4-34 MB)
   would otherwise stay in the 50 MB L2, it is taken around each call with
   the L2 flushed before it, and the warm time is kept beside it as
   `warm_ms`:
   - SNDCGAN (256x144, batch 32, base_width 512, bf16): the fused LeakyReLU
     + hash dropout forward and backward at each of the four distinct
     discriminator site shapes, bit-equal to the plain versions, the
     forward through its vector path; both timed at every site, L2 flushed
     and warm, beside a PyTorch call that moves the same bytes (`copy_`,
     `torch.add`), against a bound that prices the mask's integer work at
     the int32 rate (64 lanes an SM) beside the bytes; each pass at every
     site through its vector path. Phase 5 requires every forward and
     every backward of the SNDCGAN slice to take the vector path
     (`dropout.FWD_PATHS`, `dropout.BWD_PATHS`);
   - Keras Adam: one multi-tensor launch over every generator and
     discriminator leaf of each slice, with that slice's b1 (SNDCGAN 0.9,
     CycleGAN 0.5), bit-identical to the plain version leaf by leaf; timed
     per slice, with the host time per apply of the slice's own applies,
     beside the library call of the same update (torch._fused_adam_ with
     eps rescaled, tools/adam_times.py), first held to the plain version;
   - the Adam kernel's bfloat16-moment form (`opt_moments="bf16"`) at the
     29 SNDCGAN leaves: p, m and v bit-equal to the plain version leaf by
     leaf; timed with the L2 flushed and warm, beside the float32 form on
     the same leaves (20 bytes an element against 28);
   - CycleGAN (128x128, batch 4, base_width 64, 9 res blocks): the
     InstanceNorm forward and backward, with and without ReLU, at each of
     the seven distinct norm shapes, float32 and bfloat16; timed at the
     most frequent shape (4, 256, 32, 32) and the largest (4, 64, 128, 128)
     against the plain version, F.instance_norm and the library's backward;
     each record carries the launch plan (CTAs, cluster size, shared
     memory) at every norm shape;
   - the split InstanceNorm kernels of an H-partitioned map (forward
     partial and apply, backward partial and apply) at the generator's
     norm maps as half-height shards of 2 spatial ranks (IN_SPLIT_SHAPES),
     float32 and bfloat16, with and without ReLU, each against its plain
     version on the same inputs; the two shards together against the
     single-pass kernels on the whole map; one shard (the whole map)
     against the single-pass kernels bit for bit (the backward; the
     forward within SPLIT_WHOLE_REL); timed in float32 at every shard,
     beside the PyTorch calls that compute each kernel's function
     (tools/split_times.LIBRARY; those of the partials' sums and of the
     applies first held to the plain versions).
4. A small float32 step of each model on the card against the same step on
   the CPU (the plain kernel versions), from the same weights and inputs.
   WGAN (32x48, base 16, batch 4, n_critic 2): four steps, two of them with
   a gan update, once with the weight clip and once with the gradient
   penalty (gp_lambda 10: cuDNN's double backward); each card step starts
   from the CPU's state before it, since a free run of this trajectory
   amplifies rounding differences past its 1e-3 bound within four steps
   (PERF.md §6). The same four WGAN steps in bfloat16 (`--bf16`), with the
   clip and with the penalty, on the card alone: finite float32 losses,
   the cadence, float32 state and the clip (their numbers are held against
   the JAX bfloat16 step on the CPU, tests/test_torch_wgan_step.py). Four
   bfloat16 CycleGAN steps (`--bf16`, 96x96, base 8, 2 res blocks, batch
   1) on the card and on the CPU from one state: finite float32 metrics,
   float32 state, InstanceNorm kernels launched forward and backward, and
   each metric's distance from the CPU's float32 step within CG_BF16_BOUND
   times the CPU bf16 step's (the form and bound of the CPU gate that
   holds the bf16 step to JAX, tests/test_torch_cyclegan_bf16.py).
5. Each training slice through its entry point, one after the other, the
   launch counters zeroed just before and read just after; every kernel
   of the path must have run exactly as often as the step's structure
   says, and no other (Adam: one launch per apply), and no Adam gradient
   copied to its parameter's layout more often than GRAD_COPIES_PER_STEP:
   - SNDCGANEngine: spectral-norm D, hinge loss, bf16, one epoch with a
     checkpoint, then a new engine that resumes from it for a second epoch;
     each epoch's params-only exports (gen_model-<e>, disc_model-<e>),
     loaded into fresh models, are bit-equal to the engine's state then;
   - CycleGANEngine at the headline configuration (float32): one epoch, then
     a new engine on the same directory auto-resumes for a second; both
     generators are exported every epoch, for phase 7;
   - WGANEngine at the reference's configuration (144x256, batch 32, base
     512, float32, n_critic 5, weight clip; bench.py:445-468): one epoch of
     8 steps, then a new engine resumes for a second; gan updates at steps
     5, 10 and 15, critic_count 1 at the end, critic conv weights within
     +-0.01, and no hand kernel launched (the WGAN path has none);
   - the SNDCGAN step's options at the headline configuration, OPTION_STEPS
     steps each from the seeded state on the same batches (the step is
     the entry point: the JAX engine has no flag for either):
     `opt_moments="bf16"` (3 launches a step of the Adam kernel's bfloat16
     form, none of the float32 form; run twice, bit-equal), and
     `remat_d=True` with float32 and with bfloat16 moments (21 + 14
     dropout forwards and 21 backwards a step; state bit-equal to the run
     without it); each run's peak device memory and steps/s (after its
     first step) reported, not claimed;
   - `--profile`: SNDCGANEngine(profile=True) for two epochs of 2 steps at
     the headline configuration writes one trace, of epoch 1, under
     <dir>/traces, holding CUDA kernel events, among them the dropout
     kernels' and the Adam kernel's (launched through ctypes).
6. Sampling and FID on the SNDCGAN slice's directory, at its full width,
   with the launch counters zeroed before and read after (no hand kernel
   runs: inference uses neither dropout nor Adam):
   - the sampling CLI's two variants (exports, checkpoints) give the same
     epochs and bit-equal samples in [0, 1];
   - FIDEvaluator (spectral norm, lowrank cross term) over a 512-image
     144x256 synthetic dataset, 16 pinned batches of 32 and 4096 features:
     every FID finite and >= -1e-6 of its batch's trace terms, again equal
     from features taken anew; a resumed evaluate computes nothing, and an
     epoch dropped from fids.pickle comes back equal; on the first two
     pinned batches the `scipy` FID (float32 covariances, scipy's sqrtm)
     agrees with lowrank within its float32 rounding bound;
   - Newton–Schulz on the card against scipy.linalg.sqrtm (n = 512, SPD);
   - an image folder written here with cv2 (JPEG and PNG) read through
     ImageFolderDataset, its decoder named, then through the FID CLI's
     evaluate_fid at batch 2.
   It prints seconds per sampled epoch, per FID epoch (export load,
   features and FID math), for pinning, and the phase's peak memory, beside
   the card.
7. The evaluation path, with the launch counters zeroed before each run and
   read after it:
   - first the InstanceNorm forward kernel against its plain version at the
     seven CycleGAN norm shapes at batch 128 (the PD batch), float32, with
     and without ReLU, timed at (128, 64, 128, 128) with the L2 flushed
     against the plain version and F.instance_norm (not counted);
   - the perception-distance CLI (`cyclegan_evaluation.main`, -s 128) on
     phase 5's CycleGAN run dir, trained there with an export every epoch,
     once for models/generator_g and once for models/generator_f, over 128
     PNG images (128x128) written here with cv2: 2 epochs of 128 finite
     PDs each; exactly 24 InstanceNorm forward launches (6 + 2 x 9 norms)
     per translated batch and no other kernel; PD(x, x) exactly 0 under
     deterministic cuDNN; two pairs again on the CPU within 1e-4 relative;
   - FIDEvaluator(feature_source="inception") over the SNDCGAN run dir of
     phase 6 (16 pinned batches of 32 at 144x256, lowrank): FIDs finite and
     >= 0, the same after a resumed evaluation and after an epoch is dropped
     from fids.pickle; two images' Inception features on the card against
     the CPU within 1e-4 of the largest; no hand kernel launched.
   It prints seconds per PD epoch and per Inception-FID epoch (export load,
   features and math; host clock, each span ending in a device sync or a
   copy to the host) and the phase's peak memory, and adds the evaluation path's
   launches to every kernel's `launches_by_path`.
8. Data parallelism (parallel/dp.py, core/mesh.py), with the counters read
   per rank:
   a. the dropout kernels with an element-index base: at each of the four
      discriminator site shapes, bf16 and f32, forward and backward, the
      kernel on rank r's rows of the global batch of 32 (2 ranks) with base
      r*16*H*W*C is bit-equal to those rows of the full-batch kernel and to
      the plain version with that base; one timing at the largest site;
   b. two ranks on this one card over gloo, named explicitly (gloo reduces
      CUDA tensors through the host; NCCL runs one rank per card): the
      headline SNDCGANEngine (256x144, global batch 32 as 2 x 16, base 512,
      SN, hinge, bf16) for a 2-step epoch and a resumed one; per rank and
      step 21 + 21 dropout launches, 3 Adam launches, 3 gradient
      all-reduces, no Adam gradient copy; the ranks' digests equal after
      each epoch; artifacts from rank 0 only. Then small float32 2-rank
      steps (SNDCGAN with dropout, WGAN with the clip and with the penalty,
      CycleGAN with the InstanceNorm kernels) against the one-process steps
      on the card: metrics within 1e-3 of max(1, |v|) (WGAN's
      ill-conditioned steps 1e-2), and each step's state, per collection,
      within 1e-3 of its largest |v| (WGAN 0.15): DP_STEP_BOUND;
      the rates printed are of two ranks sharing one card;
   c. the same engine over NCCL on two cards where the machine has two
      (else a line says it was skipped), and a world-1 NCCL group through
      the engine either way.
   Rank 0's launches in (b) are every kernel's `launches_by_path`
   ["data_parallel"].
9. Spatial H-partitioning (parallel/halo.py, core/mesh.py), config 5
   (bench.py:360-411: 512x288, batch 16, base 512, SN, hinge, bf16,
   dropout 0.5):
   a. the dropout kernels on H-shards: at each of the four config-5 site
      shapes, bf16 and f32, forward and backward (each through its vector
      path), the kernel on image rows
      [s*H/2, (s+1)*H/2) (and on batch rows [B/2, B) of image rows [H/2,
      H)) with the row-block index mapping is bit-equal to the plain
      version with the same mapping and to those elements of the whole
      array's call; timed on image rows [H/2, H) of the largest site, L2
      flushed and warm, beside the contiguous call of as many elements;
   b. two spatial ranks (data 1 x spatial 2) sharing this card over gloo,
      through SNDCGANEngine, for a 4-step epoch and a resumed one, against
      the one-card engine on the same batches: each epoch's metrics within
      SP_BOUND; per rank and step 21 + 21 dropout launches, 3 Adam
      launches, 3 gradient all-reduces, 48 halo exchanges and 3 spatial
      sums; digests equal; artifacts from rank 0 only; the ranks' and the
      one card's peak device memory. Then, on the same ranks, the config-5
      steps of SP_REPLAYS (bf16 from the states of seeds 0 and 1, float32
      from seed 0's), each from the one card's seeded state (saved to a
      file) against the one card's state after that step, per collection:
      bf16 within SP_BOUND["state"] (a free run of bf16 steps drifts apart
      by rounding alone), float32 within SP_BOUND["state_f32"], the
      witness that the bf16 gap is rounding and the tighter hold on the
      halo; the one card's own bf16 step against its float32 step is
      printed beside them;
   c. on the same ranks, small float32 WGAN steps (clip and penalty, 32x32,
      base 16, n_critic 2) against one process on the card, each step from
      the one-process state before it, within DP_STEP_BOUND["wgan"];
   d. NCCL data 2 x spatial 2 on four cards where the machine has them
      (else a line says it was skipped): epoch metrics against the
      one-card run within SP_BOUND, steps/s and global images/s beside
      the one card's.
   e. the headline CycleGAN (128x128, batch 4, base 64, 9 res blocks,
      float32) on two spatial ranks sharing this card over gloo, through
      CycleGANEngine for a 4-step epoch and an auto-resumed one, against
      the one-card engine on the same batches (epoch metrics), then a
      float32 step replayed from the one card's seeded state (its state
      per collection), both within CG_SP_BOUND; per rank and step the
      split InstanceNorm launches on the generators' norms, the
      single-pass ones on the PatchGANs', 4 Adam, and the collectives
      (halo exchanges, norm all_gathers and all_reduces, row gathers,
      spatial sums, gradient all-reduces) of cyclegan_spatial_per_step;
      digests equal; artifacts from rank 0 only; peak device memory per
      rank beside the one card's;
   f. the same over NCCL as data 2 x spatial 2 on four cards where the
      machine has them (else a line says it was skipped).
   Rank 0's launches in (b) are every kernel's `launches_by_path`
   ["spatial"], in (e) ["cyclegan_spatial"]. `--only-phase 9` runs the
   build and phase 9a-9d alone, `--only-phase 9e` the build and 9e
   (`--only-phase 9d` / `9f`: 9d / 9f and the one-card run it is held to,
   on a 4-card machine);
   `--plant {world_divisor,summing_head,no_halo,one_sided_halo}` runs 9b
   and 9c, `--plant {local_in_stats,d_grad_every_peer,inner_reflect}` 9e,
   with that fault planted in the ranks, and passes when it moves them
   past SP_BOUND or CG_SP_BOUND (how the bounds were shown to catch them).
10. The reference-weights migration (compat/keras_import.py) at the
   reference shapes, without h5py (the card's machine has none), with the
   launch counters zeroed before and read after: the Keras layer lists of
   a reference SNDCGAN generator (256x144, base 512; its Dense kernel is
   128 x 294,912) and of the CycleGAN generator (128x128, base 64, 9 res
   blocks; per-channel norms and tfa axis=1 per-H norms), made from a
   numpy seed as the .h5 readers return them, go through the port's
   mapping functions, `export_params` and `load_params` into models on the
   card (the base width from the export, `bridge.sndcgan_base_width`), the
   export and the card's weights bit-equal to the tree; the SNDCGAN export
   is sampled by the sampling CLI on the card and on the CPU, and each
   CycleGAN export translates one batch on the card and on the CPU, each
   within MIGRATION_BOUND; exactly 24 InstanceNorm forwards (the
   per-channel translation) and no other kernel. It prints its seconds and
   peak device memory beside the card; the launches are every kernel's
   `launches_by_path["migration"]`. `--only-phase 10` runs the build and
   phase 10 alone.

Output: progress lines, then a JSON line with one record per kernel, the
card's `name, power.limit` line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.cli import (
    cyclegan_evaluation,
    generator_evaluation,
    generator_output,
)
from imagegeneration_tpu_torch.core import checkpoint as ckptlib
from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.core import metrics as metricslib
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core.checkpoint import load_params
from imagegeneration_tpu_torch.core.data import ImageFolderDataset, SyntheticImageDataset
from imagegeneration_tpu_torch.evalx.fid import (
    MAX_BATCHES,
    FIDEvaluator,
    calculate_fid_from_features,
)
from imagegeneration_tpu_torch.core.rng import KeyChain
from imagegeneration_tpu_torch.evalx import inception
from imagegeneration_tpu_torch.evalx import pd as pdlib
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.models.cyclegan import Generator as CycleGANGenerator
from imagegeneration_tpu_torch.models.sndcgan import (
    DISC_TRUNK,
    Discriminator,
    Generator,
    SNDCGANConfig,
    trunk_hw,
)
from imagegeneration_tpu_torch.models.wgan import CLIP_VALUE, WGANConfig, critic_kernels
from imagegeneration_tpu_torch.ops import adam, dropout, native
from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.ops.sqrtm import sqrtm_newton_schulz
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.tools import dp_parity
from imagegeneration_tpu_torch.tools import adam_times, dropout_times
from imagegeneration_tpu_torch.tools import in_plans as in_plans_tool
from imagegeneration_tpu_torch.tools import split_times
from imagegeneration_tpu_torch.tools.devtime import L2Flush, device_ms
from imagegeneration_tpu_torch.train import cyclegan_step
from imagegeneration_tpu_torch.train import sndcgan_step as steplib
from imagegeneration_tpu_torch.train import wgan_step
from imagegeneration_tpu_torch.train.cyclegan_engine import LOSS_KEYS as CG_LOSS_KEYS
from imagegeneration_tpu_torch.train.cyclegan_engine import CycleGANEngine
from imagegeneration_tpu_torch.train.sndcgan_engine import SNDCGANEngine
from imagegeneration_tpu_torch.train.wgan_engine import WGANEngine

HEIGHT, WIDTH, BATCH, BASE = 144, 256, 32, 512
EPOCH_BATCHES = 8
BF16_ULP = 2.0**-7  # one bfloat16 ulp is at most |v| * 2^-7
# The headline CycleGAN configuration (bench.py:489-503).
CG_SIZE, CG_BATCH, CG_BASE, CG_RES = 128, 4, 64, 9
# Distinct InstanceNorm shapes (B, C, H, W) of its step: G stem/up1,
# down0/up0, down1 + 18 res-block norms, to_rgb; D conv1-3.
IN_SHAPES = [(4, 64, 128, 128), (4, 128, 64, 64), (4, 256, 32, 32), (4, 3, 128, 128),
             (4, 128, 30, 30), (4, 256, 14, 14), (4, 512, 6, 6)]
IN_FREQUENT, IN_LARGEST = IN_SHAPES[2], IN_SHAPES[0]
# The generator's norm maps as half-height shards (2 spatial ranks): stem
# and up1, down0 and up0, down1 and the 18 res-block norms, to_rgb.
IN_SPLIT_SHAPES = [(4, 64, 64, 128), (4, 128, 32, 64), (4, 256, 16, 32), (4, 3, 64, 128)]
IN_SPLIT_FREQUENT = IN_SPLIT_SHAPES[2]
# The split pair against the single-pass kernels on the same float32 map:
# each output within this share of its (b, c) plane's scale (the forward
# partial's chunks and Chan's merge sum in another order than the
# single-pass kernel's clusters).
SPLIT_WHOLE_REL = 1e-6
# The CPU gate's bound (tests/test_torch_cyclegan_bf16.BOUND): a metric of
# the bf16 CycleGAN step on the card may sit this many times as far from the
# float32 step (on the CPU) as the CPU's bf16 step does.
CG_BF16_BOUND = 2.0
EPS = 1e-3  # tfa InstanceNormalization's epsilon, the models' value
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
KERNELS = ("leaky_relu_dropout", "adam", "instance_norm")
# Adam gradients copied to their parameter's layout per step (PERF.md §6):
# none, conv weights, their moments and cuDNN's gradients are channels_last.
GRAD_COPIES_PER_STEP = {"sndcgan": 0, "cyclegan": 0}
# The reference WGAN configuration (bench.py:445-468): the SNDCGAN image
# size, batch and base width, float32, n_critic 5, weight clipping.
WGAN_N_CRITIC = 5
# Every launch counter of the hand kernels: zeroed and read as one set, so
# that no path can launch a kernel that goes uncounted.
LAUNCH_COUNTERS = (dropout.LAUNCHES, adam.LAUNCHES, adam.BF16_LAUNCHES, inorm.LAUNCHES,
                   inorm.SPLIT_LAUNCHES)
# The SNDCGAN step's options (phase 5): steps per run, the first untimed.
OPTION_STEPS = 4
# FID phase: MAX_BATCHES pinned batches of the headline batch size.
FID_IMAGES = MAX_BATCHES * BATCH
FID_FLOOR = 1e-6  # an FID may fall below 0 by this share of its trace terms
EPS32 = 2.0**-24  # float32 unit roundoff
NS_TOL = 1e-4  # Newton–Schulz vs scipy.linalg.sqrtm: max abs err / max |sqrtm|
# Evaluation phase: the PD CLI's default sample size, the CycleGAN norm
# shapes at that batch, and the relative bound of card against CPU.
PD_IMAGES = 128
IN_EVAL_SHAPES = [(PD_IMAGES, *s[1:]) for s in IN_SHAPES]
IN_EVAL_TIMED = IN_EVAL_SHAPES[0]
IN_PER_TRANSLATION = 6 + 2 * CG_RES  # InstanceNorm forwards per generator pass
EVAL_RTOL = 1e-4
# Migration phase (10): one batch of samples (SNDCGAN, in [0, 1]) or
# translations (CycleGAN, in [-1, 1]) from imported weights on the card
# against the same batch on the CPU, max absolute difference: float32 in
# other summation orders (TF32 off).
MIGRATION_BATCH = 4
MIGRATION_BOUND = 1e-4
# Data-parallel phase: ranks, global batches per epoch, and the bounds of
# the small 2-rank float32 steps against one process on the card, as
# (metric error relative to max(1, |v|), state error per collection
# relative to its largest |v|; small_dp_errors). Set from runs on an H100
# 80GB HBM3 at 700 W of sound ranks and of ranks with a planted fault
# (local BatchNorm statistics; a sum for the mean): sound, metrics <= 1.6e-7
# and states <= 9.4e-6 (SNDCGAN, CycleGAN), metrics <= 6.9e-4 and states
# <= 2.3e-2 (WGAN: RMSprop moves every entry by ~sqrt(10) * lr whatever its
# gradient, clipped convs feed BatchNorm, so a rounding flips some signs);
# faulty, metrics >= 4.6e-2 where a model has BatchNorm and states >= 0.98
# in every case (a sum for the mean moves the Adam runs' metrics only
# 4.2e-5 to 2.5e-4, its moments by the world size). Each bound sits well
# clear of both.
DP_WORLD = 2
DP_EPOCH_BATCHES = 4
DP_RANKS_TIMEOUT_S = 400  # each spawn of phase 8 ends its ranks past this
DP_STEP_BOUND = {"sndcgan": (1e-3, 1e-3), "cyclegan": (1e-3, 1e-3), "wgan": (1e-2, 0.15)}
# Spatial phase: config 5 (bench.py:360-411: 512x288, batch 16, SN, hinge,
# bf16) on 2 spatial ranks, 4 batches an epoch; the halo exchanges per
# step (G 4 convs, D 7: the G pass 22, each D pass 13); and the bound of
# the ranks against the one-card run (spatial_errors: each epoch's metric
# error relative to max(1, |v|); each replayed step's state error per
# collection over its largest |v|, bf16 and float32 apart). Set from runs
# on an H100 80GB HBM3 at 700 W. Sound: metric 1.76e-3-1.85e-3; bf16 state
# 9.76e-2 and 9.14e-2 (seeds 0 and 1), float32 state 5.15e-3; the one
# card's own bf16 step is 0.170 from its float32 step, so the bf16 gap is
# within bf16's rounding. Planted faults (plant_fault), metric / bf16 /
# float32 state: world divisor 1.24e-3 / 0.762 / 0.750, a summing head
# backward 3.28e-3 / 3.24 / 3.00, no halo 2.78e-2 / 0.363 / 0.385, a
# one-sided halo 1.42e-2 / 0.359 / 0.425. Only the states catch the first
# two, as in phase 8. The float32 bound is 3.9x its sound reading and 19x
# under the least fault; the bf16 bound 1.8x the sound and the size of
# bf16's own rounding; the metric bound 2.7x the sound.
C5_HEIGHT, C5_WIDTH, C5_BATCH = 288, 512, 16
SP_SPATIAL = 2
SP_EPOCH_BATCHES = 4
SP_HALOS_PER_STEP = 48
SP_RANKS_TIMEOUT_S = 400
SP_BOUND = {"metric": 5e-3, "state": 0.175, "state_f32": 2e-2}
SP_FAULTS = ("world_divisor", "summing_head", "no_halo", "one_sided_halo")
# Phase 9e: the headline CycleGAN (float32) on 2 spatial ranks, 4 batches an
# epoch, against the one-card engine (cyclegan_spatial_errors: each epoch's
# metric error relative to max(1, |v|); a replayed float32 step's state
# error per collection over its largest |v|), and the planted faults that
# the bound must catch. Set from runs on an H100 80GB HBM3 at 700 W: sound,
# metric 2.8e-7, state 2.2e-4 (the one card's own float32 step run twice:
# 4.3e-5 to 2.0e-4, cuDNN's run to run); planted faults (plant_cyclegan_
# fault), metric / state: each shard's own statistics 1.1e-5 / 0.694, the
# PatchGANs' gradients on every peer 3.1e-4 / 3.0, inner edges reflected
# 3.0e-7 / 0.0306. Only the state catches them. The state bound is 14x its
# sound reading and 10x under the least fault; the metric bound 350x its
# sound reading.
CG_SP_SPATIAL = 2
CG_SP_EPOCH_BATCHES = 4
CG_SP_BOUND = {"metric": 1e-4, "state": 3e-3}
CG_FAULTS = ("local_in_stats", "d_grad_every_peer", "inner_reflect")
# The replayed config-5 steps of phase 9b: (label, compute dtype, seed of
# the state and of the batch). bf16 is config 5's own; the float32 step is
# the witness that the bf16 gap is rounding, and is held to its own bound.
SP_REPLAYS = (("bf16", torch.bfloat16, 0), ("bf16_seed1", torch.bfloat16, 1),
              ("f32", torch.float32, 0))


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def timing(kernel, plain, library=None, iters: int = 20,
           flush: L2Flush | None = None) -> dict:
    """Device ms of the kernel's wrapper, its plain version and, where there
    is one, the library call; with `flush`, timed with the L2 flushed
    between calls, and warm beside it (`warm_ms`, `plain_warm_ms`, ...)."""
    out = {"library_ms": None}
    for prefix, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is not None:
            out[f"{prefix}ms"] = device_ms(fn, iters, flush=flush)
            if flush is not None:
                out[f"{prefix}warm_ms"] = device_ms(fn, iters)
    return out


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zero_launches() -> None:
    for counts in (*LAUNCH_COUNTERS, adam.GRAD_COPIES, dropout.FWD_PATHS, dropout.BWD_PATHS):
        for k in counts:
            counts[k] = 0


def no_launches() -> dict[str, int]:
    """Every launch counter's key at 0."""
    return {k: 0 for counts in LAUNCH_COUNTERS for k in counts}


def read_launches() -> dict[str, int]:
    torch.cuda.synchronize()
    return {k: v for counts in LAUNCH_COUNTERS for k, v in counts.items()}


def max_ulp_f32(a: torch.Tensor, b: torch.Tensor) -> int:
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((key(a) - key(b)).abs().max())


def site_launches() -> dict[tuple[int, int, int, int], int]:
    """Dropout launches per headline step at each distinct (B, C, H, W) site
    shape of the headline D, in trunk order: one per trunk layer of that
    shape in each of the step's three D passes."""
    per_shape, h, w = {}, HEIGHT, WIDTH
    for filters, _, (sh, sw) in DISC_TRUNK:
        h, w = -(-h // sh), -(-w // sw)
        shape = (BATCH, filters, h, w)
        per_shape[shape] = per_shape.get(shape, 0) + steplib.N_SITES // len(DISC_TRUNK)
    return per_shape


def disc_site_shapes() -> list[tuple[int, int, int, int]]:
    """The distinct (B, C, H, W) dropout-site shapes of the headline D."""
    return list(site_launches())


def check_dropout(dev: torch.device, card: str) -> list[dict]:
    """Kernel vs plain, bit for bit, at every distinct D site shape of the
    headline step (bf16, channels_last), each pass through its vector
    path; both kernels timed at every site, L2 flushed and warm, beside the
    plain version and a PyTorch call that moves the same bytes (the
    forward's `copy_`, the backward's `torch.add(x, g, out=dx)`: the card's
    practical ceiling); the record's times are the largest site's."""
    kw = KeyChain(7).dropout_kw(torch.zeros((), dtype=torch.int64, device=dev), 1)[0]
    cut = dropout.dropout_cut(0.5)
    names = ("leaky_relu_dropout_fwd", "leaky_relu_dropout_bwd")
    shapes, per_step = disc_site_shapes(), site_launches()
    flush = L2Flush(dev)
    sites = {name: [] for name in names}
    max_err = dict.fromkeys(names, 0.0)
    for shape in shapes:
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        g = g.contiguous(memory_format=torch.channels_last)
        b, c, h, w = shape
        keep_kernel = dropout.fwd_kernel(torch.ones_like(x), kw, cut) != 0
        keep_plain = dropout.hash_keep_mask(kw, x.numel(), cut).view(
            b, h, w, c).permute(0, 3, 1, 2)
        require(torch.equal(keep_kernel, keep_plain),
                f"dropout mask differs from plain at {shape}")
        frac = keep_kernel.float().mean().item()
        require(abs(frac - 0.5) < 1e-3, f"dropout keep fraction {frac} at {shape}")
        vector = (dropout.FWD_PATHS["vector"], dropout.BWD_PATHS["vector"])
        for name, kernel, plain in (
            (names[0], lambda: dropout.fwd_kernel(x, kw, cut),
             lambda: dropout.fwd_plain(x, kw, cut)),
            (names[1], lambda: dropout.bwd_kernel(x, g, kw, cut),
             lambda: dropout.bwd_plain(x, g, kw, cut)),
        ):
            yk, yp = kernel(), plain()
            max_err[name] = max(max_err[name], (yk.float() - yp.float()).abs().max().item())
            require(torch.equal(yk.view(torch.int16), yp.view(torch.int16)),
                    f"{name} {shape}: not bit-equal to the plain version")
            del yk, yp
        require((dropout.FWD_PATHS["vector"], dropout.BWD_PATHS["vector"])
                == (vector[0] + 1, vector[1] + 1),
                f"the forward or backward at {shape} did not take the vector path")
        out = torch.empty_like(x)
        for name, kernel, plain, ceiling, n_tensors in (
            (names[0], lambda: dropout.fwd_kernel(x, kw, cut),
             lambda: dropout.fwd_plain(x, kw, cut), lambda: out.copy_(x), 2),
            (names[1], lambda: dropout.bwd_kernel(x, g, kw, cut),
             lambda: dropout.bwd_plain(x, g, kw, cut), lambda: torch.add(x, g, out=out), 3),
        ):
            times = timing(kernel, plain, flush=flush)
            times["copy_ms"] = device_ms(ceiling, 20, flush=flush)
            times["copy_warm_ms"] = device_ms(ceiling, 20)
            site = {"shape_nchw": list(shape), "launches_per_step": per_step[shape], **times,
                    **dropout_times.bound(n_tensors, x.numel(), x.element_size())}
            site["share"] = site["bound_ms"] / site["ms"]
            sites[name].append(site)
            log(f"{name} at {shape} bf16 ({site['launches_per_step']} a step): "
                f"{times['ms']:.4f} ms flushed, {times['warm_ms']:.4f} warm; bound "
                f"{site['bound_ms']:.4f} (bytes {site['bytes_ms']:.4f}, int32 "
                f"{site['int_ms']:.4f}), {100 * site['share']:.0f}%; copy of the same bytes "
                f"{times['copy_ms']:.4f} / {times['copy_warm_ms']:.4f}; plain "
                f"{times['plain_ms']:.4f} ms ({card})")
        del x, g, out, keep_kernel, keep_plain
    del flush
    records = []
    for name, line in ((names[0], 50), (names[1], 61)):
        largest = sites[name][0]
        records.append({
            "name": name, "route": "cuda",
            "source": "imagegeneration_tpu_torch/csrc/leaky_relu_dropout.cu",
            "replaces": f"imagegeneration_tpu/ops/pallas/dropout.py:{line}",
            "max_abs_err": max_err[name], "tolerance": "bit-equal to the plain version",
            "checked_shapes_nchw": [list(s) for s in shapes],
            **{k: v for k, v in largest.items() if k != "shape_nchw"},
            "timed_shape_nhwc": [largest["shape_nchw"][i] for i in (0, 2, 3, 1)],
            "dtype": "bfloat16", "sites": sites[name],
            "ms_per_step": sum(s["ms"] * s["launches_per_step"] for s in sites[name]),
            "bound_ms_per_step": sum(s["bound_ms"] * s["launches_per_step"]
                                     for s in sites[name]),
            "library_note": "no PyTorch call computes this hash-masked dropout",
        })
        log(f"{name}: {records[-1]['ms_per_step']:.4f} ms a step at the four sites "
            f"(flushed), bound {records[-1]['bound_ms_per_step']:.4f} ({card})")
    return records


def adam_leaves(path: str, dev: torch.device) -> tuple[list[list[torch.Tensor]], float]:
    """The leaves of each model of one headline slice's state (one Adam
    apply each: SNDCGAN G, D; CycleGAN G, F, D_X, D_Y), and its b1."""
    if path == "sndcgan":
        state = steplib.init_state(steplib.SNDCGANTrainConfig(model=SNDCGANConfig(
            image_size=(HEIGHT, WIDTH, 3), base_width=BASE, spectral_norm=True,
            dtype=torch.bfloat16)), dev)
        return [[p.detach() for p in m.parameters()] for m in (state.gen, state.disc)], 0.9
    cfg = cyclegan_step.CycleGANTrainConfig(model=CycleGANConfig(
        image_size=(CG_SIZE, CG_SIZE, 3), base_width=CG_BASE, n_res_blocks=CG_RES))
    state = cyclegan_step.init_state(cfg, dev)
    models = (state.gen_g, state.gen_f, state.disc_x, state.disc_y)
    return [[p.detach() for p in m.parameters()] for m in models], cfg.beta1


def adam_host_us(models: list[list[torch.Tensor]], b1: float, dev: torch.device,
                 rounds: int = 20) -> dict:
    """Host microseconds per apply of `adam.adam_apply` (perf_counter
    around the calls, no sync: what the step's host thread spends), over
    each model's leaves with its own table, as the step applies them."""
    gen = torch.Generator(device=dev).manual_seed(2)
    per_model = []
    for leaves in models:
        params = [p.clone() for p in leaves]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        grads = [torch.empty_like(p).normal_(generator=gen) for p in params]
        count = torch.zeros((), dtype=torch.int64, device=dev)
        table = adam.LeafTable(params, m, v)
        per_model.append((params, grads, m, v, count, table))
    us = []
    for params, grads, m, v, count, table in per_model:
        for _ in range(3):
            adam.adam_apply(params, grads, m, v, count, 2e-4, b1, 0.999, table)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            adam.adam_apply(params, grads, m, v, count, 2e-4, b1, 0.999, table)
        us.append((time.perf_counter() - t0) * 1e6 / rounds)
        torch.cuda.synchronize()
    return {"host_us_per_apply_by_model": us, "host_us_per_apply": sum(us) / len(us)}


def check_adam_path(path: str, dev: torch.device, card: str) -> dict:
    """One multi-tensor launch over every leaf of one slice, with its b1,
    against the plain version leaf by leaf (0 ulp); then that apply timed,
    and the host time per apply of the slice's own applies."""
    models, b1 = adam_leaves(path, dev)
    leaves = [p for ps in models for p in ps]
    gen = torch.Generator(device=dev).manual_seed(1)
    # In each leaf's own layout (channels_last conv weights), as the step
    # hands them to the kernel.
    grads = [torch.empty_like(p).normal_(generator=gen) for p in leaves]
    ms_ = [torch.empty_like(p).normal_(generator=gen) for p in leaves]
    vs_ = [torch.empty_like(p).uniform_(generator=gen) for p in leaves]
    alpha = adam.adam_alpha(torch.tensor(3, device=dev), 2e-4, b1, 0.999)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))
    pp, mp, vp = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))
    table = adam.LeafTable(pk, mk, vk)
    adam.adam_kernel(table, grads, alpha, b1, 0.999)
    adam.adam_plain(pp, grads, mp, vp, alpha, b1, 0.999)
    worst = 0
    max_err = 0.0
    for a, b in zip(pk + mk + vk, pp + mp + vp):
        worst = max(worst, max_ulp_f32(a, b))
        max_err = max(max_err, (a - b).abs().max().item())
    require(worst == 0, f"adam kernel {worst} ulp from plain on {path} leaves (bound 0)")
    # The one PyTorch call of the same update (tools/adam_times.py), held to
    # the plain version first.
    lib_distance = adam_times.library_distance(leaves, grads, ms_, vs_, b1, adam)
    require(max(lib_distance.values()) <= adam_times.LIBRARY_MAX_ULP,
            f"adam library call {lib_distance} ulps from plain on {path} leaves")
    pl, ml, vl = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))

    times = timing(lambda: adam.adam_kernel(table, grads, alpha, b1, 0.999),
                   lambda: adam.adam_plain(pk, grads, mk, vk, alpha, b1, 0.999),
                   adam_times.library_call(pl, grads, ml, vl, b1), iters=10)
    host = adam_host_us(models, b1, dev)
    n = sum(p.numel() for p in leaves)
    log(f"adam on {path} ({len(leaves)} leaves, {n:,} elements, b1={b1}): one launch "
        f"({len(table.launches)} group, {adam.grid_ctas()} CTAs, chunk {adam.CHUNK}) "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, library call "
        f"{times['library_ms']:.4f} ms ({lib_distance} ulps of its terms from plain) device "
        f"time, max {worst} ulp; host {host['host_us_per_apply']:.1f} us per apply of the step's "
        f"{len(models)} models ({card})")
    # read p, g, m, v and write p, m, v; ~12 float32 operations each
    return {"b1": b1, "leaves": len(leaves), "elements": n, "max_abs_err": max_err,
            "max_ulp": worst, "library_distance_ulps": lib_distance,
            "launches_per_apply_all_leaves": len(table.launches),
            "grid_ctas": adam.grid_ctas(), "chunk": adam.CHUNK, **times, **host,
            **bound(28 * n, 12 * n)}


def check_adam(dev: torch.device, card: str) -> dict:
    """Kernel vs plain on the leaves of both slices. The record's times and
    bound are one apply over the CycleGAN leaves, the path whose launches it
    reports; `by_path` holds each slice's own."""
    by_path = {p: check_adam_path(p, dev, card) for p in ("sndcgan", "cyclegan")}
    main = by_path["cyclegan"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "leaves", "elements",
            "host_us_per_apply")
    return {
        "name": "adam", "route": "cuda", "source": "imagegeneration_tpu_torch/csrc/adam.cu",
        "replaces": "imagegeneration_tpu/ops/pallas/adam.py:69",
        "max_abs_err": max(r["max_abs_err"] for r in by_path.values()),
        "max_ulp": max(r["max_ulp"] for r in by_path.values()), "tolerance": "0 ulp",
        **{k: main[k] for k in keys}, "by_path": by_path,
        "ms_is_per": "one launch over every CycleGAN G and D leaf (b1 0.5)",
        "library_call": adam_times.LIBRARY,
        "library_note": "torch._fused_adam_ with eps / sqrt(1 - b2^t) is the Keras "
                        "update: (sqrt(v) / sqrt(1 - b2^t) + eps') = (sqrt(v) + eps) / "
                        "sqrt(1 - b2^t); held to the plain version in ulps of each "
                        "element's terms (tools/adam_times.library_distance)",
    }


def check_adam_bf16(dev: torch.device, card: str) -> dict:
    """The bfloat16-moment form in one launch over the 29 SNDCGAN leaves
    against the plain version leaf by leaf (p, m, v bit-equal); timed with
    the L2 flushed and warm, beside the float32 form on the same leaves."""
    models, b1 = adam_leaves("sndcgan", dev)
    leaves = [p for ps in models for p in ps]
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.empty_like(p).normal_(generator=gen) for p in leaves]
    ms_ = [torch.empty_like(p).normal_(generator=gen).to(torch.bfloat16) for p in leaves]
    vs_ = [torch.empty_like(p).uniform_(generator=gen).to(torch.bfloat16) for p in leaves]
    require(all(m.stride() == p.stride() for m, p in zip(ms_, leaves)), "bf16 moment layout")
    alpha = adam.adam_alpha(torch.tensor(3, device=dev), 2e-4, b1, 0.999)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))
    pp, mp, vp = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))
    table = adam.LeafTable(pk, mk, vk)
    require(table.moment_dtype == torch.bfloat16, "bf16 leaf table")
    adam.adam_kernel(table, grads, alpha, b1, 0.999)
    adam.adam_plain(pp, grads, mp, vp, alpha, b1, 0.999)
    max_err = 0.0
    for i, (a, b) in enumerate(zip(pk + mk + vk, pp + mp + vp)):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int16
        require(torch.equal(a.view(bits), b.view(bits)),
                f"adam bf16 form: leaf {i % len(leaves)} of {'pmv'[i // len(leaves)]} "
                "differs from plain")
        max_err = max(max_err, (a.float() - b.float()).abs().max().item())
    n = sum(p.numel() for p in leaves)
    flush = L2Flush(dev)
    times = timing(lambda: adam.adam_kernel(table, grads, alpha, b1, 0.999),
                   lambda: adam.adam_plain(pk, grads, mk, vk, alpha, b1, 0.999),
                   iters=10, flush=flush)
    f32_table = adam.LeafTable([t.clone() for t in leaves], [t.float() for t in ms_],
                               [t.float() for t in vs_])
    f32_times = timing(lambda: adam.adam_kernel(f32_table, grads, alpha, b1, 0.999),
                       None, iters=10, flush=flush)
    record = {
        "name": "adam_bf16", "route": "cuda", "source": "imagegeneration_tpu_torch/csrc/adam.cu",
        "replaces": "imagegeneration_tpu/ops/pallas/adam.py:69",
        "replaces_note": "the JAX package computes bfloat16 moments outside Pallas, in the "
                         "inline XLA formula (imagegeneration_tpu/train/common.py:125-138); "
                         "the port's form is this kernel's bfloat16-moment template",
        "entry_point": "adam_multi_bf16", "max_abs_err": max_err, "tolerance": "0 ulp",
        "leaves": len(leaves), "elements": n, "b1": b1,
        "grid_ctas": adam.grid_ctas(torch.bfloat16), **times,
        "f32_form_ms": f32_times["ms"], "f32_form_warm_ms": f32_times["warm_ms"],
        # read p, g, m, v and write p, m, v: 4 + 4 + 4 + 2 * 2 * 2 bytes
        **bound(20 * n, 12 * n),
        "library_note": "torch.optim.Adam adds eps to sqrt(v_hat) after bias-correcting "
                        "m and v and keeps its moments in the parameters' dtype; no "
                        "PyTorch call computes this update",
        "ms_is_per": "one launch over every SNDCGAN G and D leaf (b1 0.9), L2 flushed "
                     "before each; warm_ms without",
    }
    log(f"adam bf16-moment form on sndcgan ({len(leaves)} leaves, {n:,} elements): p, m, v "
        f"bit-equal to plain; {times['ms']:.4f} ms flushed, {times['warm_ms']:.4f} ms warm "
        f"(float32 form {f32_times['ms']:.4f} / {f32_times['warm_ms']:.4f} ms), plain "
        f"{times['plain_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms ({card})")
    return record


def check_small_step_against_cpu(dev: torch.device) -> None:
    """Two float32 steps of a small config on the card and on the CPU."""
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(32, 48, 3), base_width=32, spectral_norm=True),
        batch_size=4, loss="hinge")
    gen = torch.Generator().manual_seed(3)
    batches = torch.randint(0, 256, (2, 4, 32, 48, 3), generator=gen, dtype=torch.uint8)
    zs = torch.rand((2, 4, 128), generator=gen) * 2 - 1
    kw = torch.randint(0, 2**32, (steplib.N_SITES, 2), generator=gen, dtype=torch.int64)
    results = []
    for d in (torch.device("cpu"), dev):
        state = steplib.init_state(cfg, d)
        step = steplib.make_train_step(cfg)
        ms = []
        for i in range(2):
            state, m = step(state, batches[i].to(d), zs[i].to(d), kw.to(d))
            ms.append({k: float(v) for k, v in m.items()})
        sample = steplib.make_sampler(cfg)(state, zs[0].to(d)).cpu()
        results.append((ms, sample))
    (m_cpu, s_cpu), (m_gpu, s_gpu) = results
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for k in b:
            require(math.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-3 * max(1.0, abs(b[k])),
                    f"small step {i} {k}: cuda {a[k]} vs cpu {b[k]}")
    err = (s_gpu - s_cpu).abs().max().item()
    require(err <= 1e-3, f"small step samples differ by {err}")
    log(f"small float32 step, card vs CPU: metrics within 1e-3, samples max abs err {err:.3g}")


def in_inputs(dev: torch.device, shape, dtype) -> tuple[torch.Tensor, ...]:
    """x ~ N(2, 3), dy ~ N(0, 1) (channels_last), gamma ~ N(1, 0.1), beta ~
    N(0, 0.1), as the JAX package's kernel tests draw them."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (2.0 + 3.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    cl = torch.channels_last
    return x.contiguous(memory_format=cl), dy.contiguous(memory_format=cl), gamma, beta


def in_close(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
             terms: int = 128) -> float:
    """Require |got - want| <= tol * sqrt(terms / 128) + (tol + ulp) |want|:
    rtol/atol `tol` (tests/test_pallas_ops.py), the atol of a sum of `terms`
    float32 values scaled by sqrt(terms / 128) from those tests' 128, and one
    bf16 ulp (2^-7 |v|) for a bf16 output. Returns the max abs error."""
    ulp = BF16_ULP if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = tol * max(1.0, (terms / 128) ** 0.5) + (tol + ulp) * want.abs()
    require(bool((err <= limit).all()),
            f"{what}: beyond tolerance by {(err - limit).max().item():.3g}")
    return err.max().item()


def in_plans(shape, dtype=torch.float32) -> dict:
    """The forward's and the backward's launch plans at one shape, each with
    how many of its clusters the card holds at once."""
    b, c, h, w = shape
    out = {}
    for part, tensors in (("fwd", 1), ("bwd", 2)):
        plan = inorm.launch_plan(b, c, h, w, dtype, tensors)
        out[part] = {**vars(plan), "active_clusters": inorm.active_clusters(
            plan, c, h * w, dtype, backward=tensors == 2)}
    return out


def time_instance_norm(shape, flush: L2Flush) -> dict:
    """Kernel, plain and library device times (float32) at one shape, with
    the L2 flushed between calls and warm."""
    dev = torch.device("cuda", 0)
    x, dy, gamma, beta = in_inputs(dev, shape, torch.float32)
    b, c, h, w = shape
    n = x.numel()
    _, mean, rstd = inorm.in_fwd_plain(x, gamma, beta, EPS, False)
    library_bwd = in_plans_tool.library_bwd(x, dy, gamma, mean, rstd)
    dx_lib = library_bwd()[0].view(b, c, h, w)
    dx_plain = inorm.in_bwd_plain(x, dy, gamma, beta, mean, rstd, False)[0]
    require(torch.allclose(dx_lib, dx_plain, rtol=1e-4, atol=1e-4),
            f"native_batch_norm_backward is not the same function at {shape}")
    xg, gg, bg = (t.detach().clone().requires_grad_(True) for t in (x, gamma, beta))

    def fwd_bwd(norm):
        return lambda: torch.autograd.grad(norm(xg, gg, bg), (xg, gg, bg), dy)

    return {
        "fwd": {
            **timing(lambda: inorm.in_fwd_kernel(x, gamma, beta, EPS, False),
                     lambda: inorm.in_fwd_plain(x, gamma, beta, EPS, False),
                     in_plans_tool.library_fwd(x, gamma, beta), flush=flush),
            # read x, gamma, beta, write y, mean, rstd; ~10 operations per
            # element (3 passes)
            **bound(4 * (2 * n + 2 * b * c + 2 * c), 10 * n),
        },
        "bwd": {
            **timing(lambda: inorm.in_bwd_kernel(x, dy, gamma, beta, mean, rstd, False),
                     lambda: inorm.in_bwd_plain(x, dy, gamma, beta, mean, rstd, False),
                     library_bwd, flush=flush),
            # read x, dy, mean, rstd, gamma, beta; write dx, dgamma, dbeta;
            # ~14 operations per element
            **bound(4 * (3 * n + 2 * b * c + 4 * c), 14 * n),
        },
        "fwd_bwd_ms": device_ms(fwd_bwd(lambda x, g, b: inorm.instance_norm(x, g, b, EPS))),
        "library_fwd_bwd_ms": device_ms(
            fwd_bwd(lambda x, g, b: F.instance_norm(x, weight=g, bias=b, eps=EPS))),
    }


def check_instance_norm(card: str) -> list[dict]:
    """Kernel vs plain at every distinct norm shape of the headline CycleGAN
    step, float32 and bfloat16, with and without the fused ReLU. The
    backward takes the plain forward's mean and rstd, so both rebuild the
    same ReLU mask. Timed in float32 at the most frequent and the largest
    shape."""
    dev = torch.device("cuda", 0)
    names = ("instance_norm_fwd", "instance_norm_bwd")
    max_err = {(k, dt): 0.0 for k in names for dt in ("float32", "bfloat16")}
    for shape in IN_SHAPES:
        terms = shape[0] * shape[2] * shape[3]
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, gamma, beta = in_inputs(dev, shape, dtype)
            dt = str(dtype).split(".")[1]
            for relu in (False, True):
                at = f"{shape} {dt} relu={relu}"
                y, mean, rstd = inorm.in_fwd_kernel(x, gamma, beta, EPS, relu)
                yp, meanp, rstdp = inorm.in_fwd_plain(x, gamma, beta, EPS, relu)
                errs = [in_close(f"fwd y {at}", y, yp, 2e-5),
                        in_close(f"fwd mean {at}", mean, meanp, 1e-5),
                        in_close(f"fwd rstd {at}", rstd, rstdp, 1e-5)]
                max_err[names[0], dt] = max(max_err[names[0], dt], *errs)
                if relu:
                    require(torch.equal(y == 0, yp == 0), f"fwd zero pattern {at}")
                dx, dg, db = inorm.in_bwd_kernel(x, dy, gamma, beta, meanp, rstdp, relu)
                dxp, dgp, dbp = inorm.in_bwd_plain(x, dy, gamma, beta, meanp, rstdp, relu)
                errs = [in_close(f"bwd dx {at}", dx, dxp, 2e-5),
                        in_close(f"bwd dgamma {at}", dg, dgp, 2e-5, terms),
                        in_close(f"bwd dbeta {at}", db, dbp, 2e-5, terms)]
                max_err[names[1], dt] = max(max_err[names[1], dt], *errs)
        log(f"instance norm kernels at {shape}: within tolerance, f32/bf16, relu off/on, "
            "ReLU zero pattern identical")
    torch.cuda.synchronize()

    flush = L2Flush(dev)
    timed = {"most_frequent": time_instance_norm(IN_FREQUENT, flush),
             "largest": time_instance_norm(IN_LARGEST, flush)}
    del flush  # 512 MiB the training slices can use
    plans = {str(tuple(s)): in_plans(s) for s in IN_SHAPES}
    out = []
    for name, part, line in ((names[0], "fwd", 66), (names[1], "bwd", 137)):
        rec = {
            "name": name, "route": "cuda",
            "source": "imagegeneration_tpu_torch/csrc/instance_norm.cu",
            "replaces": f"imagegeneration_tpu/ops/pallas/instance_norm.py:{line}",
            "max_abs_err": max_err[name, "float32"],
            "max_abs_err_bf16": max_err[name, "bfloat16"],
            "tolerance": "rtol/atol 2e-5 (mean, rstd 1e-5; dgamma/dbeta atol x "
                         "sqrt(B*H*W/128)); bf16 + 1 ulp",
            "checked_shapes_nchw": [list(s) for s in IN_SHAPES],
            **timed["most_frequent"][part],
            "timed_shape_nchw": list(IN_FREQUENT), "dtype": "float32",
            "library_call": "F.instance_norm" if part == "fwd"
                            else "aten.native_batch_norm_backward on the (1, B*C, H, W) view",
            "at_largest": {"shape_nchw": list(IN_LARGEST), **timed["largest"][part]},
            "plans_f32": {s: p[part] for s, p in plans.items()},
        }
        if part == "bwd":
            rec["fwd_bwd_ms"] = {k: timed[k]["fwd_bwd_ms"] for k in timed}
            rec["library_fwd_bwd_ms"] = {k: timed[k]["library_fwd_bwd_ms"] for k in timed}
        out.append(rec)
        for where, t in timed.items():
            shape = IN_FREQUENT if where == "most_frequent" else IN_LARGEST
            r, plan = t[part], plans[str(shape)][part]
            log(f"{name} at {where} {shape}"
                f" f32 device time, L2 flushed (warm): kernel {r['ms']:.4f} "
                f"({r['warm_ms']:.4f}) ms, plain {r['plain_ms']:.4f} ({r['plain_warm_ms']:.4f})"
                f" ms, library {r['library_ms']:.4f} ({r['library_warm_ms']:.4f}) ms, bound "
                f"{r['bound_ms']:.4f} ms; plan {plan['ctas']} CTAs, cluster "
                f"{plan['cluster']}, {plan['smem_bytes']} B shared ({card})")
    for where, t in timed.items():
        log(f"instance norm fwd+bwd through autograd at {where}, device time: kernels "
            f"{t['fwd_bwd_ms']:.4f} ms, F.instance_norm {t['library_fwd_bwd_ms']:.4f} ms "
            f"({card})")
    return out


SPLIT_NAMES = tuple(inorm.SPLIT_LAUNCHES)


def split_shards(x: torch.Tensor, shards: int) -> list[torch.Tensor]:
    """The row blocks of a (B, C, H, W) map, each channels_last."""
    return [t.contiguous(memory_format=torch.channels_last) for t in x.chunk(shards, 2)]


def plane_close(what: str, got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor,
                rel: float = SPLIT_WHOLE_REL) -> float:
    """Require |got - want| <= rel * scale, `scale` the (b, c) plane's (or the
    channel's) scale broadcast over `want`; returns the largest error over
    its scale."""
    err = (got.float() - want.float()).abs()
    scale = scale.float().reshape(*scale.shape, *([1] * (want.dim() - scale.dim())))
    worst = (err / scale.clamp_min(1e-30)).max().item()
    require(bool((err <= rel * scale).all()), f"{what}: {worst:.3g} of the scale, bound {rel:g}")
    return worst


def split_whole_errors(at: str, x, dy, gamma, beta, relu, split: tuple, whole: tuple,
                       mean, rstd) -> float:
    """The split pair against the single-pass kernels on the same float32
    map (y, mean, rstd, dx, dgamma, dbeta) within SPLIT_WHOLE_REL of each
    (b, c) plane's scale: max |y|, max |x| (mean), rstd, max |dx|; for
    dgamma and dbeta each channel's sum of |dy' xhat| and |dy'| (the sums'
    scale). Returns the worst error over its scale."""
    xhat, dym = inorm._masked(x, dy, gamma, beta, mean, rstd, relu)
    scales = (whole[0].float().abs().amax((2, 3)), x.float().abs().amax((2, 3)), whole[2],
              whole[3].float().abs().amax((2, 3)), (dym * xhat).abs().sum((0, 2, 3)),
              dym.abs().sum((0, 2, 3)))
    names = ("y", "mean", "rstd", "dx", "dgamma", "dbeta")
    return max(plane_close(f"split {n} vs whole {at}", g, w, sc)
               for n, g, w, sc in zip(names, split, whole, scales))


def launch_floor(flush: L2Flush) -> dict:
    """An empty kernel's device time in the kernels' harness (tools/devtime.py):
    torch.cuda._sleep(0), one thread that returns at once; L2 flushed
    (events around each call) and warm (back-to-back calls)."""
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    return {"ms": device_ms(empty, flush=flush), "warm_ms": device_ms(empty)}


def time_split_pair(shape, flush: L2Flush) -> dict:
    """The four split kernels, their plain versions and the library calls
    (torch.var_mean beside the forward partial; native_batch_norm_backward
    beside the backward partial; batch_norm_gather_stats_with_counts then
    batch_norm_elemt beside the forward apply; batch_norm_backward_elemt
    beside the backward apply; the last three first held to the plain
    versions at ReLU off, the kernels' own tolerances) at one shard,
    float32, L2 flushed and warm, each with its bound; the calls are
    tools/split_times.split_calls's."""
    dev = torch.device("cuda", 0)
    b, c, h, w = shape
    x, dy, gamma, beta = in_inputs(dev, shape, torch.float32)
    calls = split_times.split_calls(inorm, x, dy, gamma, beta, SP_SPATIAL, plain=True)
    _, plain_bwd, library_bwd = calls[SPLIT_NAMES[2]]
    in_close(f"native_batch_norm_backward vs the plain backward partial at {shape}",
             split_times.library_partial_sums(library_bwd(), gamma), plain_bwd()[0], 2e-5,
             h * w)
    _, plain_fwd_apply, library_fwd_apply = calls[SPLIT_NAMES[1]]
    for what, got, want, tol in zip(("y", "mean", "invstd"), library_fwd_apply(),
                                    plain_fwd_apply(), (2e-5, 1e-5, 1e-5)):
        in_close(f"gather_stats_with_counts + batch_norm_elemt {what} vs the plain forward "
                 f"apply at {shape}", got.view(want.shape), want, tol)
    _, plain_bwd_apply, library_bwd_apply = calls[SPLIT_NAMES[3]]
    in_close(f"batch_norm_backward_elemt vs the plain backward apply at {shape}",
             library_bwd_apply().view(shape), plain_bwd_apply(), 2e-5)
    k = inorm.fwd_partial_plan(b, c, h, w, torch.float32).chunks
    n, small = x.numel() * 4, 4 * b * c * 2
    extra = {
        # read x, write the k chunks' (sum, M2)
        SPLIT_NAMES[0]: {**bound(n + k * small, 4 * x.numel()), "chunks": k},
        SPLIT_NAMES[1]: bound(2 * n + SP_SPATIAL * k * small + small, 4 * x.numel()),
        SPLIT_NAMES[2]: {**bound(2 * n + 2 * small, 8 * x.numel()),
                         "chunks": inorm.bwd_partial_plan(b, c, h, w, torch.float32).chunks},
        SPLIT_NAMES[3]: bound(3 * n + 2 * small, 8 * x.numel()),
    }
    return {name: {**timing(*calls[name], flush=flush), **extra[name]} for name in SPLIT_NAMES}


def check_split_instance_norm(card: str) -> list[dict]:
    """The split InstanceNorm kernels against their plain versions on the
    same inputs, at the generator's half-height shards of the headline
    CycleGAN (IN_SPLIT_SHAPES), float32 and bfloat16, ReLU off and on: the
    two shards' forward partials (each against the plain partial cut into
    the kernel's chunks), the apply of each shard from both shards'
    partials, the backward partial of each shard (from the merged mean and
    rstd) and the apply from the shards' summed sums. The two shards'
    kernels together, and the pair on one shard (the whole map), are held
    to the single-pass kernels on the whole map: float32 within
    SPLIT_WHOLE_REL of each plane's scale (split_whole_errors), bfloat16
    within rtol/atol 2e-5 + 1 ulp; on one shard the backward (the partial,
    then the apply) is also bit-equal to the single-pass backward, whose
    CTAs and orders its partial keeps. Timed in float32 at every shard, L2
    flushed and warm, beside the plain versions, the library calls of
    tools/split_times.LIBRARY (time_split_pair), and an empty kernel's
    launch (launch_floor)."""
    dev = torch.device("cuda", 0)
    max_err = {(k, dt): 0.0 for k in SPLIT_NAMES for dt in ("float32", "bfloat16")}
    whole_rel = {"two_shards": 0.0, "one_shard": 0.0}
    for shape in IN_SPLIT_SHAPES:
        b, c, h, w = shape
        whole = (b, c, h * SP_SPATIAL, w)
        total = h * SP_SPATIAL * w
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, gamma, beta = in_inputs(dev, whole, dtype)
            dt = str(dtype).split(".")[1]
            xs, dys = split_shards(x, SP_SPATIAL), split_shards(dy, SP_SPATIAL)

            def err(name, *e):
                max_err[name, dt] = max(max_err[name, dt], *e)

            def against_whole(label, at, split, mean, rstd):
                got = tuple(split)
                want = (*inorm.in_fwd_kernel(x, gamma, beta, EPS, relu),
                        *inorm.in_bwd_kernel(x, dy, gamma, beta, mean, rstd, relu))
                if dtype == torch.float32:
                    whole_rel[label] = max(whole_rel[label], split_whole_errors(
                        f"{label} {at}", x, dy, gamma, beta, relu, got, want, mean, rstd))
                    return
                terms = b * total
                for name, g, w_, tol, t in zip(("y", "mean", "rstd", "dx", "dgamma", "dbeta"),
                                               got, want, (2e-5, 1e-5, 1e-5, 2e-5, 2e-5, 2e-5),
                                               (128, 128, 128, 128, terms, terms)):
                    in_close(f"{label} {name} vs whole {at}", g, w_, tol, t)

            for relu in (False, True):
                at = f"shard {shape} of {whole} {dt} relu={relu}"
                parts = []
                for xb in xs:
                    got = inorm.in_fwd_partial_kernel(xb)
                    want = inorm.in_fwd_partial_plain(xb, got.shape[0])
                    require(got.shape == want.shape, f"fwd partial chunks {at}")
                    rows = -(-h * w // got.shape[0])
                    err(SPLIT_NAMES[0], in_close(f"fwd partial {at}", got, want, 2e-5, rows))
                    parts.append(got)
                parts = torch.stack(parts)
                ys, sums, dgs, dbs = [], 0, 0, 0
                for xb in xs:
                    y, mean, rstd = inorm.in_fwd_apply_kernel(xb, parts, gamma, beta, EPS, relu)
                    yp, meanp, rstdp = inorm.in_fwd_apply_plain(xb, parts, gamma, beta, EPS,
                                                                relu)
                    err(SPLIT_NAMES[1], in_close(f"fwd apply y {at}", y, yp, 2e-5),
                        in_close(f"fwd apply mean {at}", mean, meanp, 1e-5),
                        in_close(f"fwd apply rstd {at}", rstd, rstdp, 1e-5))
                    ys.append(y)
                for xb, db in zip(xs, dys):
                    sm, dg, dbt = inorm.in_bwd_partial_kernel(xb, db, gamma, beta, mean, rstd,
                                                              relu)
                    smp, dgp, dbp = inorm.in_bwd_partial_plain(xb, db, gamma, beta, mean, rstd,
                                                               relu)
                    err(SPLIT_NAMES[2],
                        in_close(f"bwd partial sums {at}", sm, smp, 2e-5, h * w),
                        in_close(f"bwd partial dgamma {at}", dg, dgp, 2e-5, b * h * w),
                        in_close(f"bwd partial dbeta {at}", dbt, dbp, 2e-5, b * h * w))
                    sums, dgs, dbs = sums + sm, dgs + dg, dbs + dbt
                dxs = []
                for xb, db in zip(xs, dys):
                    dx = inorm.in_bwd_apply_kernel(xb, db, sums, gamma, beta, mean, rstd, relu,
                                                   total)
                    dxp = inorm.in_bwd_apply_plain(xb, db, sums, gamma, beta, mean, rstd, relu,
                                                   total)
                    err(SPLIT_NAMES[3], in_close(f"bwd apply dx {at}", dx, dxp, 2e-5))
                    dxs.append(dx)
                # the shards together, then one shard (the whole map), against
                # the single-pass kernels on the map
                against_whole("two_shards", at, (torch.cat(ys, 2), mean, rstd,
                                                 torch.cat(dxs, 2), dgs, dbs), mean, rstd)
                y1, m1, r1 = inorm.in_fwd_apply_kernel(
                    x, inorm.in_fwd_partial_kernel(x)[None], gamma, beta, EPS, relu)
                s1, dg1, db1 = inorm.in_bwd_partial_kernel(x, dy, gamma, beta, m1, r1, relu)
                dx1 = inorm.in_bwd_apply_kernel(x, dy, s1, gamma, beta, m1, r1, relu, total)
                against_whole("one_shard", at, (y1, m1, r1, dx1, dg1, db1), m1, r1)
                dxw1, dgw1, dbw1 = inorm.in_bwd_kernel(x, dy, gamma, beta, m1, r1, relu)
                require(all(torch.equal(a, b_) for a, b_ in (
                    (dx1, dxw1), (dg1, dgw1), (db1, dbw1))),
                    f"one shard's backward is not the single-pass backward's bits {at}")
        log(f"split instance norm kernels at the shard {shape}: within tolerance of plain; "
            "as 2 shards and as 1 within the bound of the single-pass kernels on the whole "
            "map, and the 1-shard backward bit-equal to it; f32/bf16, relu off/on")
    torch.cuda.synchronize()
    log(f"split vs single-pass on the whole map, float32, worst error over the plane's scale "
        f"(bound {SPLIT_WHOLE_REL:g}): 2 shards {whole_rel['two_shards']:.3g}, 1 shard "
        f"{whole_rel['one_shard']:.3g}")

    flush = L2Flush(dev)
    floor = launch_floor(flush)
    timed = {tuple(shape): time_split_pair(shape, flush) for shape in IN_SPLIT_SHAPES}
    del flush
    log(f"empty kernel (torch.cuda._sleep(0)) in the same harness: {floor['ms']:.4f} ms "
        f"flushed, {floor['warm_ms']:.4f} ms warm ({card})")
    largest, frequent = tuple(IN_SPLIT_SHAPES[0]), tuple(IN_SPLIT_FREQUENT)
    out = []
    for name in SPLIT_NAMES:
        line = 66 if "fwd" in name else 137
        plan = dict(zip(SPLIT_NAMES, (inorm.fwd_partial_plan, inorm.fwd_apply_plan,
                                      inorm.bwd_partial_plan, inorm.bwd_apply_plan)))[name]
        out.append({
            "name": name, "route": "cuda",
            "source": "imagegeneration_tpu_torch/csrc/instance_norm.cu",
            "replaces": f"imagegeneration_tpu/ops/pallas/instance_norm.py:{line}",
            "max_abs_err": max_err[name, "float32"],
            "max_abs_err_bf16": max_err[name, "bfloat16"],
            "tolerance": "rtol/atol 2e-5 (mean, rstd 1e-5; sums atol x sqrt(rows/128), "
                         "dgamma/dbeta x sqrt(B*h*W/128)); bf16 + 1 ulp",
            "split_vs_whole_f32": {**whole_rel, "bound": SPLIT_WHOLE_REL,
                                   "of": "each (b, c) plane's scale"},
            "one_shard_bwd_bit_equal_to_single_pass": True,
            "checked_shapes_nchw": [list(sh) for sh in IN_SPLIT_SHAPES],
            **timed[largest][name], "timed_shape_nchw": list(largest), "dtype": "float32",
            "library_call": split_times.LIBRARY.get(name),
            "at_most_frequent": {"shape_nchw": list(frequent), **timed[frequent][name]},
            "at_shapes": [{"shape_nchw": list(sh), **t[name]} for sh, t in timed.items()],
            "launch_floor_ms": floor,
            "plan_f32": vars(plan(*largest, torch.float32)),
        })
        for sh, t in timed.items():
            t = t[name]
            lib = (f", library ({split_times.LIBRARY[name]}) {t['library_ms']:.4f} "
                   f"({t['library_warm_ms']:.4f})" if t["library_ms"] is not None else "")
            log(f"{name} at the shard {sh} f32 device time, L2 flushed (warm): kernel "
                f"{t['ms']:.4f} ({t['warm_ms']:.4f}) ms, plain {t['plain_ms']:.4f} "
                f"({t['plain_warm_ms']:.4f}){lib}, bound {t['bound_ms']:.4f} ms, empty "
                f"kernel {floor['ms']:.4f} ({floor['warm_ms']:.4f}) ({card})")
    return out


def check_small_cyclegan_step_against_cpu(dev: torch.device) -> None:
    """Two float32 CycleGAN steps (96x96, base 8, 2 res blocks, batch 1) on
    the card and on the CPU, from the same weights and batches."""
    cfg = cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=(96, 96, 3), base_width=8, n_res_blocks=2))
    gen = torch.Generator().manual_seed(5)
    batches = torch.randint(0, 256, (2, 2, 1, 96, 96, 3), generator=gen, dtype=torch.uint8)
    probe = batches[0, 0].float() / 127.5 - 1.0
    translate_g, _ = cyclegan_step.make_translators()
    results = []
    for d in (torch.device("cpu"), dev):
        state = cyclegan_step.init_state(cfg, d)
        step = cyclegan_step.make_train_step(cfg)
        ms = []
        for bx, by in batches:
            state, m = step(state, bx.to(d), by.to(d))
            ms.append({k: float(v) for k, v in m.items()})
        results.append((ms, translate_g(state, probe.to(d)).cpu()))
    (m_cpu, img_cpu), (m_gpu, img_gpu) = results
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for k in b:
            require(math.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-3 * max(1.0, abs(b[k])),
                    f"small cyclegan step {i} {k}: cuda {a[k]} vs cpu {b[k]}")
    err = (img_gpu - img_cpu).abs().max().item()
    require(err <= 1e-3, f"small cyclegan step translations differ by {err}")
    log(f"small float32 CycleGAN step, card vs CPU: 9 metrics within 1e-3, "
        f"translation max abs err {err:.3g}")


def check_small_wgan_steps_against_cpu(dev: torch.device) -> None:
    """Four float32 WGAN steps (32x48, base 16, batch 4, n_critic 2) on the
    CPU; each step again on the card from the CPU's state before it, with
    the same batch and latents (and interpolation weights with the
    gradient penalty). Metrics within 1e-3, and the samples of the last
    step's generator."""
    gen = torch.Generator().manual_seed(6)
    batches = torch.randint(0, 256, (4, 4, 32, 48, 3), generator=gen, dtype=torch.uint8)
    z_fake = torch.randn((4, 4, 128), generator=gen)
    z_gan = torch.randn((4, 4, 128), generator=gen)
    gp_eps = torch.rand((4, 4, 1, 1, 1), generator=gen)
    cpu = torch.device("cpu")
    for gp_lambda in (0.0, 10.0):
        cfg = wgan_step.WGANTrainConfig(
            model=WGANConfig(image_size=(32, 48, 3), base_width=16), batch_size=4,
            n_critic=2, gp_lambda=gp_lambda)
        step = wgan_step.make_train_step(cfg)
        sample = wgan_step.make_sampler(cfg)
        cpu_state = wgan_step.init_state(cfg, cpu)
        card_state = wgan_step.init_state(cfg, dev)
        did, worst, at = [], 0.0, "all equal"
        for i in range(4):
            # load_state_dict copies every tensor before the CPU step moves it
            card_state.load_state_dict(
                {**cpu_state.state_dict(), "z_gen": card_state.z_gen.get_state()})
            results = []
            for state, d in ((cpu_state, cpu), (card_state, dev)):
                eps = gp_eps[i].to(d) if gp_lambda else None
                _, m = step(state, batches[i].to(d), z_fake[i].to(d), z_gan[i].to(d), eps)
                results.append({k: float(v) for k, v in m.items()})
            m_cpu, m_gpu = results
            for k, b in m_cpu.items():
                a = m_gpu[k]
                require(math.isfinite(a) and abs(a - b) <= 1e-3 * max(1.0, abs(b)),
                        f"small wgan step {i} (gp {gp_lambda}) {k}: cuda {a} vs cpu {b}")
                if abs(a - b) / max(1.0, abs(b)) > worst:
                    worst, at = abs(a - b) / max(1.0, abs(b)), f"{k} at step {i}"
            require(card_state.critic_count == cpu_state.critic_count, "critic_count")
            did.append(m_gpu["did_gan_update"])
        require(did == [0.0, 1.0, 0.0, 1.0], f"small wgan gan updates {did}")
        if not gp_lambda:
            k = max(w.abs().max().item() for w in critic_kernels(card_state.critic))
            require(k <= CLIP_VALUE, f"critic conv weights reach {k}")
        err = (sample(card_state, z_fake[0].to(dev)).cpu()
               - sample(cpu_state, z_fake[0])).abs().max().item()
        require(err <= 1e-3, f"small wgan step samples differ by {err}")
        log(f"small float32 WGAN steps (gp_lambda {gp_lambda}), card vs CPU from the same "
            f"state each step: metrics within {worst:.3g} ({at}; bound 1e-3), gan updates {did}, "
            f"samples max abs err {err:.3g}")


def check_small_wgan_bf16_steps(dev: torch.device) -> None:
    """Four bfloat16 WGAN steps (32x48, base 16, batch 4, n_critic 2) on the
    card, with the clip and with the gradient penalty: finite float32
    losses, gan updates at the second and fourth step, float32 parameters,
    statistics and optimizer state, conv weights within the clip."""
    gen = torch.Generator().manual_seed(7)
    batches = torch.randint(0, 256, (4, 4, 32, 48, 3), generator=gen, dtype=torch.uint8)
    for gp_lambda in (0.0, 10.0):
        cfg = wgan_step.WGANTrainConfig(
            model=WGANConfig(image_size=(32, 48, 3), base_width=16, dtype=torch.bfloat16),
            batch_size=4, n_critic=2, gp_lambda=gp_lambda)
        step = wgan_step.make_train_step(cfg)
        state = wgan_step.init_state(cfg, dev)
        did, losses = [], []
        for i in range(4):
            state, m = step(state, batches[i].to(dev))
            require(all(v.dtype == torch.float32 for v in m.values()), "bf16 wgan metric dtype")
            m = {k: float(v) for k, v in m.items()}
            require(all(math.isfinite(v) for v in m.values()), f"bf16 wgan step {i}: {m}")
            did.append(m["did_gan_update"])
            losses.append(m["c_loss_real"])
        require(did == [0.0, 1.0, 0.0, 1.0], f"bf16 wgan gan updates {did}")
        tensors = [*state.gen.parameters(), *state.critic.parameters(), *state.gen.buffers(),
                   *state.critic.buffers(), *state.c_opt.nu, *state.gan_opt.nu]
        require({t.dtype for t in tensors} == {torch.float32}, "bf16 wgan state dtype")
        if not gp_lambda:
            k = max(w.abs().max().item() for w in critic_kernels(state.critic))
            require(k <= CLIP_VALUE, f"bf16 critic conv weights reach {k}")
        log(f"small bfloat16 WGAN steps (gp_lambda {gp_lambda}) on the card: finite, gan "
            f"updates {did}, float32 state, c_loss_real {[round(v, 4) for v in losses]}")


def check_small_cyclegan_bf16_steps(dev: torch.device) -> dict:
    """Four bfloat16 CycleGAN steps (96x96, base 8, 2 res blocks, batch 1) on
    the card, and the same steps on the CPU in bfloat16 and in float32, from
    one seeded state: finite float32 metrics, float32 parameters and Adam
    moments, the InstanceNorm kernels launched forward and backward, and
    each metric's distance from the CPU float32 step (summed over the
    steps) within CG_BF16_BOUND times the CPU bf16 step's: the CPU gate's
    form, the CPU's bf16 step in the place of JAX's and its float32 step in
    the place of the float64 reference. Returns each metric's ratio."""
    gen = torch.Generator().manual_seed(8)
    batches = torch.randint(0, 256, (4, 2, 1, 96, 96, 3), generator=gen, dtype=torch.uint8)
    model = dict(image_size=(96, 96, 3), base_width=8, n_res_blocks=2)
    seed = cyclegan_step.init_state(cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(**model)), "cpu").state_dict()
    cpu = torch.device("cpu")
    runs = {}
    for label, d, dtype in (("card", dev, torch.bfloat16), ("cpu", cpu, torch.bfloat16),
                            ("cpu_f32", cpu, torch.float32)):
        cfg = cyclegan_step.CycleGANTrainConfig(model=CycleGANConfig(**model, dtype=dtype))
        state = cyclegan_step.init_state(cfg, d)
        state.load_state_dict(seed)
        step = cyclegan_step.make_train_step(cfg)
        zero_launches()
        metrics = []
        for bx, by in batches:
            state, m = step(state, bx.to(d), by.to(d))
            require(all(v.dtype == torch.float32 for v in m.values()),
                    f"bf16 cyclegan {label}: metric dtypes")
            metrics.append({k: float(v) for k, v in m.items()})
        runs[label] = (state, metrics, read_launches())
    state, metrics, launches = runs["card"]
    require(all(math.isfinite(v) for m in metrics for v in m.values()),
            f"bf16 cyclegan steps on the card: {metrics}")
    tensors = [t for name in ("gen_g", "gen_f", "disc_x", "disc_y")
               for t in getattr(state, name).parameters()]
    for opt in (state.gg_opt, state.gf_opt, state.dx_opt, state.dy_opt):
        tensors += [*opt.mu, *opt.nu]
    require({t.dtype for t in tensors} == {torch.float32}, "bf16 cyclegan state dtype")
    require(launches["instance_norm_fwd"] > 0 and launches["instance_norm_bwd"] > 0,
            f"bf16 cyclegan steps launched {launches}")

    def distance(a, b, k):
        return sum(abs(x[k] - y[k]) for x, y in zip(a, b))

    cpu_bf16, cpu_f32 = runs["cpu"][1], runs["cpu_f32"][1]
    ratios = {k: distance(metrics, cpu_f32, k) / distance(cpu_bf16, cpu_f32, k)
              for k in metrics[0]}
    worst = max(ratios, key=ratios.get)
    require(ratios[worst] <= CG_BF16_BOUND,
            f"bf16 cyclegan metric {worst}: the card {ratios[worst]:.3g} x as far from "
            f"float32 as the CPU bf16 step (bound {CG_BF16_BOUND})")
    log(f"small bfloat16 CycleGAN steps on the card: finite float32 metrics, float32 "
        f"state, InstanceNorm launches fwd {launches['instance_norm_fwd']} bwd "
        f"{launches['instance_norm_bwd']}; per metric the card "
        f"{min(ratios.values()):.3g}-{ratios[worst]:.3g} ({worst}) x as far from the CPU's "
        f"float32 step as the CPU bf16 step (bound {CG_BF16_BOUND})")
    return ratios


def model_states(state) -> dict[str, dict[str, torch.Tensor]]:
    """CPU copies of the generator's and discriminator's tensors."""
    return {name: {k: v.detach().cpu().clone()
                   for k, v in getattr(state, name).state_dict().items()}
            for name in ("gen", "disc")}


def check_exports(out: str, cfg: SNDCGANConfig, states: dict) -> int:
    """Each epoch's exports, loaded into fresh models, bit-equal to the
    engine's state at that epoch; returns the tensors compared."""
    n = 0
    for epoch, want in states.items():
        for name, cls, path in (
                ("gen", Generator, f"{out}/models/generator/gen_model-{epoch}.msgpack"),
                ("disc", Discriminator,
                 f"{out}/models/discriminator/disc_model-{epoch}.msgpack")):
            fresh = cls(cfg)
            bridge.load_flax_variables(fresh, load_params(path))
            got = fresh.state_dict()
            require(sorted(got) == sorted(want[name]), f"{path}: tensors {sorted(got)}")
            for k, v in got.items():
                require(torch.equal(v, want[name][k]), f"{path}: {k} differs from the state")
            n += len(got)
    return n


def run_sndcgan_slice(card: str, work: str) -> dict:
    """The headline SNDCGAN configuration through SNDCGANEngine in
    `work`/sndcgan, which the sampling and FID phase reads afterwards."""
    dev = torch.device("cuda", 0)
    dataset = SyntheticImageDataset(EPOCH_BATCHES * BATCH, (HEIGHT, WIDTH))
    kwargs = dict(image_size=(HEIGHT, WIDTH, 3), device=dev, spectral_norm=True,
                  loss="hinge", dtype=torch.bfloat16, base_width=BASE,
                  live_output=f"{work}/live")
    out = f"{work}/sndcgan"
    engine = SNDCGANEngine(out, dataset, BATCH, **kwargs)
    zero_launches()
    engine.train(1, 1)  # epoch 0, checkpointed and exported
    states = {0: model_states(engine.state)}
    first = engine.last_epoch_metrics
    resumed = SNDCGANEngine(out, dataset, BATCH, continue_=True, **kwargs)
    require(resumed.start_epoch == 1, "resume did not start at epoch 1")
    require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
    resumed.train(2, 1)  # epoch 1
    launches = read_launches()
    fwd_paths, bwd_paths = dict(dropout.FWD_PATHS), dict(dropout.BWD_PATHS)
    states[1] = model_states(resumed.state)
    copies = adam.GRAD_COPIES["adam"]
    second = resumed.last_epoch_metrics
    with open(f"{out}/perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    steps = int(resumed.state.step)
    n_exported = check_exports(out, engine.cfg.model, states)
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    for name, m in (("epoch 0", first), ("epoch 1", second)):
        require(all(math.isfinite(v) for v in m.values()), f"{name} losses {m}")
    want = {
        **no_launches(),
        "leaky_relu_dropout_fwd": steplib.N_SITES * steps,
        "leaky_relu_dropout_bwd": steplib.N_SITES * steps,
        "adam": 3 * steps,  # G, then D twice (d_updates=2): one launch each
    }
    require(launches == want, f"launch counts {launches}, expected {want}")
    # every forward and backward of the main path on the vector path
    want_paths = {"vector": steplib.N_SITES * steps, "scalar": 0}
    require(fwd_paths == want_paths, f"dropout forward paths {fwd_paths}, expected {want_paths}")
    require(bwd_paths == want_paths, f"dropout backward paths {bwd_paths}, expected {want_paths}")
    want_copies = GRAD_COPIES_PER_STEP["sndcgan"] * steps
    require(copies == want_copies, f"adam gradient copies {copies}, expected {want_copies}")
    log(f"sndcgan slice: {steps} steps over 2 epochs (one resumed), losses {second}")
    log(f"sndcgan slice: launches {launches}, dropout forward paths {fwd_paths}, backward "
        f"paths {bwd_paths}, adam gradient layout copies {copies}")
    log(f"sndcgan slice: exports gen_model-{{0,1}} and disc_model-{{0,1}} loaded into "
        f"fresh models: {n_exported} tensors bit-equal to the engine's state at each epoch")
    log(f"sndcgan slice: epoch 1 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.1f} images/s at {WIDTH}x{HEIGHT} bs{BATCH} "
        f"base {BASE} SN hinge bf16 ({card})")
    return {"launches": launches, "fwd_paths": fwd_paths, "bwd_paths": bwd_paths,
            "grad_copies": copies, "perf": perf,
            "config": f"{HEIGHT}x{WIDTH} bs{BATCH} base{BASE} SN hinge bf16 d_updates=2"}


def run_cyclegan_slice(card: str, work: str) -> dict:
    """The headline CycleGAN configuration through CycleGANEngine in
    `work`/cyclegan: one epoch, then a new engine that auto-resumes on the
    same directory; both generators exported every epoch, for the
    evaluation phase."""
    dev = torch.device("cuda", 0)
    datasets = [SyntheticImageDataset(EPOCH_BATCHES * CG_BATCH, (CG_SIZE, CG_SIZE), seed=s)
                for s in (1, 2)]
    kwargs = dict(device=dev, base_width=CG_BASE, n_res_blocks=CG_RES, dtype=torch.float32)
    size = (CG_SIZE, CG_SIZE)
    out = f"{work}/cyclegan"
    engine = CycleGANEngine(*datasets, out, CG_BATCH, size, **kwargs)
    require(engine.epoch == 0 and engine.resident, "fresh resident engine")
    zero_launches()
    engine.train(1, checkpoint_frequency=1)  # epoch 0, checkpoint 1
    first = engine.last_epoch_metrics
    resumed = CycleGANEngine(*datasets, out, CG_BATCH, size, **kwargs)
    require(resumed.epoch == 1, f"auto-resume gave epoch {resumed.epoch}")
    require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
    resumed.train(1, checkpoint_frequency=1)  # epoch 1, checkpoint 2
    launches = read_launches()
    copies = adam.GRAD_COPIES["adam"]
    second = resumed.last_epoch_metrics
    with open(f"{out}/perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    with open(f"{out}/losses.pickle", "rb") as f:
        history = pickle.load(f)
    checkpoints = resumed.ckpt_manager.all_epochs()
    probe = torch.from_numpy(datasets[0].images[:1]).to(dev).float() / 127.5 - 1.0
    image = resumed.translate_g(resumed.state, probe)
    steps = int(resumed.state.step)
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    for name, m in (("epoch 0", first), ("epoch 1", second)):
        require(all(math.isfinite(v) for v in m.values()), f"{name} losses {m}")
    require(sorted(history) == sorted(CG_LOSS_KEYS)
            and all(len(v) == 2 for v in history.values()), f"losses.pickle {history}")
    require(checkpoints == [1, 2], f"checkpoints {checkpoints}")
    require(image.shape == (1, CG_SIZE, CG_SIZE, 3) and bool(torch.isfinite(image).all())
            and image.abs().max().item() <= 1.0, "translated image")
    # Per step: 6 generator passes of 6 + 2 * n_res norms, 4 discriminator
    # passes of 3; backward: pulls 1 and 2 each run one D pass and four G
    # passes, pull 3 the four D passes (PERF.md gives the derivation); one
    # Adam launch for each of G, F, D_X and D_Y.
    in_g, in_d = 6 + 2 * CG_RES, 3
    per_step = {"instance_norm_fwd": 6 * in_g + 4 * in_d,
                "instance_norm_bwd": 2 * (in_d + 4 * in_g) + 4 * in_d,
                "adam": 4}
    require(per_step == {"instance_norm_fwd": 156, "instance_norm_bwd": 210, "adam": 4},
            f"per-step structure {per_step}")
    want = {**no_launches(), **{k: v * steps for k, v in per_step.items()}}
    require(launches == want, f"launch counts {launches}, expected {want}")
    want_copies = GRAD_COPIES_PER_STEP["cyclegan"] * steps
    require(copies == want_copies, f"adam gradient copies {copies}, expected {want_copies}")
    log(f"cyclegan slice: {steps} steps over 2 epochs (one auto-resumed), losses {second}")
    log(f"cyclegan slice: launches {launches}, adam gradient layout copies {copies}")
    log(f"cyclegan slice: epoch 1 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.2f} images/s at {CG_SIZE}x{CG_SIZE} bs{CG_BATCH} "
        f"base {CG_BASE} {CG_RES} res blocks f32 ({card})")
    return {"launches": launches, "grad_copies": copies, "perf": perf,
            "config": f"{CG_SIZE}x{CG_SIZE} bs{CG_BATCH} base{CG_BASE} res{CG_RES} f32"}


def run_wgan_slice(card: str) -> dict:
    """The reference WGAN configuration through WGANEngine: one epoch, then a
    new engine that resumes from its checkpoint for a second."""
    dev = torch.device("cuda", 0)
    dataset = SyntheticImageDataset(EPOCH_BATCHES * BATCH, (HEIGHT, WIDTH), seed=3)
    args = (dataset, (HEIGHT, WIDTH, 3), BATCH, WGAN_N_CRITIC)
    kwargs = dict(device=dev, base_width=BASE, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/wgan"
        engine = WGANEngine(*args, path_like=out, **kwargs)
        require(engine.epoch == 0 and engine.resident, "fresh resident engine")
        zero_launches()
        engine.train(1)  # epoch 1, checkpoint 1
        first = engine.last_epoch_metrics
        resumed = WGANEngine(*args, path_like=out, load=True, **kwargs)
        require(resumed.epoch == 1, f"resume gave epoch {resumed.epoch}")
        require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
        require(resumed.state.critic_count == EPOCH_BATCHES % WGAN_N_CRITIC,
                f"resumed critic_count {resumed.state.critic_count}")
        resumed.train(2)  # epoch 2, checkpoint 2
        launches = read_launches()
        copies = adam.GRAD_COPIES["adam"]
        second = resumed.last_epoch_metrics
        with open(f"{out}/perf.jsonl") as f:
            perf = [json.loads(line) for line in f]
        with open(f"{out}/stats.pickle", "rb") as f:
            history = pickle.load(f)
        checkpoints = resumed.ckpt_manager.all_epochs()
        samples = resumed.generate_fake_samples(4)
        steps = int(resumed.state.step)
        critic_count = resumed.state.critic_count
        kernel_max = max(w.abs().max().item() for w in critic_kernels(resumed.state.critic))
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    gan_steps = first["gan_update_steps"] + second["gan_update_steps"]
    require(first["gan_updates"] + second["gan_updates"] == 3 and gan_steps == [5, 10, 15],
            f"gan updates at steps {gan_steps}, expected [5, 10, 15]")
    require(critic_count == 1, f"critic_count {critic_count} after 16 steps")
    for name, m in (("epoch 1", first), ("epoch 2", second)):
        require(all(math.isfinite(v) for v in m.values() if isinstance(v, float)),
                f"{name} losses {m}")
    require(kernel_max <= CLIP_VALUE, f"critic conv weights reach {kernel_max}")
    require(checkpoints == [1, 2], f"checkpoints {checkpoints}")
    require(sorted(history) == ["c1_hist", "c2_hist", "g_hist"]
            and all(len(v) == 3 and all(map(math.isfinite, v)) for v in history.values()),
            f"stats.pickle {history}")
    require(samples.shape == (4, HEIGHT, WIDTH, 3) and samples.min() >= 0.0
            and samples.max() <= 1.0, "preview samples")
    want = dict.fromkeys(launches, 0)
    require(launches == want, f"launch counts {launches}, expected none")
    require(copies == 0, f"adam gradient copies {copies} on a path without Adam")
    log(f"wgan slice: {steps} steps over 2 epochs (one resumed), gan updates at steps "
        f"{gan_steps}, critic_count {critic_count}, critic conv weights within "
        f"{kernel_max:.4g}, losses {second}")
    log(f"wgan slice: launches {launches}")
    log(f"wgan slice: epoch 2 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.1f} images/s at {WIDTH}x{HEIGHT} bs{BATCH} base "
        f"{BASE} f32 n_critic {WGAN_N_CRITIC} clip ({card})")
    return {"launches": launches, "grad_copies": copies, "perf": perf,
            "config": f"{HEIGHT}x{WIDTH} bs{BATCH} base{BASE} f32 n_critic{WGAN_N_CRITIC} clip"}


def check_run_twice(card: str) -> dict:
    """Each slice's step at the configuration phase 5 trains (SNDCGAN bf16,
    CycleGAN and WGAN float32; WGAN over one n_critic cycle, its gan update
    included) run twice from its seeded state on the same batches: the two
    states bit-equal (sha256 of every byte, dp.state_digest), as the JAX
    steps are run to run. cuDNN is held to deterministic algorithms
    (core/platform.configure_numerics). Run after the slices' launches are
    read."""
    dev = torch.device("cuda", 0)
    runs = {
        "sndcgan": (steplib, headline_step_config(), 2),
        "cyclegan": (cyclegan_step, cyclegan_step.CycleGANTrainConfig(
            model=CycleGANConfig(image_size=(CG_SIZE, CG_SIZE, 3), base_width=CG_BASE,
                                 n_res_blocks=CG_RES), batch_size=CG_BATCH), 2),
        "wgan": (wgan_step, wgan_step.WGANTrainConfig(
            model=WGANConfig(image_size=(HEIGHT, WIDTH, 3), base_width=BASE),
            batch_size=BATCH, n_critic=WGAN_N_CRITIC), WGAN_N_CRITIC),
    }
    out = {}
    for name, (lib, cfg, steps) in runs.items():
        gen = torch.Generator(device=dev).manual_seed(7)
        batches = torch.randint(0, 256, (steps, 1 + (name == "cyclegan"), cfg.batch_size,
                                         *cfg.model.image_size),
                                generator=gen, device=dev, dtype=torch.uint8)
        states = []
        for _ in range(2):
            state, step = lib.init_state(cfg, dev), lib.make_train_step(cfg)
            for b in batches:
                state, _ = step(state, *b)
            states.append(state)
        digests = [dp.state_digest(st) for st in states]
        if digests[0] != digests[1]:
            gap = state_errors(states[0].state_dict(), states[1].state_dict())
            require(False, f"{name}: {steps} steps run twice from the same state differ "
                    f"({gap})")
        out[name] = {"steps": steps, "bit_equal": True, "digest": digests[0][:16]}
        log(f"{name}: {steps} steps from the seeded state, run twice: states bit-equal "
            f"(sha256 {digests[0][:16]}) ({card})")
        del states
        torch.cuda.empty_cache()
    return out


def headline_step_config(**options) -> steplib.SNDCGANTrainConfig:
    """The headline SNDCGAN step (SN, hinge, bf16 compute), with `options`."""
    return steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(HEIGHT, WIDTH, 3), base_width=BASE,
                            spectral_norm=True, dtype=torch.bfloat16),
        batch_size=BATCH, loss="hinge", **options)


def option_run(cfg: steplib.SNDCGANTrainConfig, batches: torch.Tensor) -> dict:
    """`len(batches)` steps of `cfg` from its seeded state through
    make_train_step (the key words and z from the state's streams): the
    launches, the state's digest, the peak device memory over the steps,
    and the steps/s after the first step."""
    dev = batches.device
    torch.cuda.empty_cache()
    state, step = steplib.init_state(cfg, dev), steplib.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state_bytes = torch.cuda.memory_allocated(dev)
    zero_launches()
    state, metrics = step(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, metrics = step(state, b)
    launches = read_launches()  # synchronizes
    seconds = time.perf_counter() - t0
    out = {"launches": launches, "grad_copies": adam.GRAD_COPIES["adam"],
           "digest": dp.state_digest(state), "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "state_bytes": state_bytes, "steps_per_sec": (len(batches) - 1) / seconds,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "moments": sorted({str(t.dtype) for t in state.g_opt.mu + state.d_opt.nu})}
    require(all(math.isfinite(v) for v in out["metrics"].values()),
            f"{cfg.opt_moments} remat_d={cfg.remat_d}: losses {out['metrics']}")
    del state
    return out


def run_sndcgan_options(card: str) -> dict:
    """The SNDCGAN step's opt_moments="bf16" and remat_d at the headline
    configuration: exact launch counts, bit-equal states (the bf16 run
    twice; remat_d against the run without it, float32 and bf16 moments),
    peak memory and steps/s beside each."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    batches = torch.randint(0, 256, (OPTION_STEPS, BATCH, HEIGHT, WIDTH, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
    runs = {}
    for label, moments, remat in (("f32", "f32", False), ("f32_remat_d", "f32", True),
                                  ("bf16", "bf16", False), ("bf16_again", "bf16", False),
                                  ("bf16_remat_d", "bf16", True)):
        runs[label] = option_run(headline_step_config(opt_moments=moments, remat_d=remat),
                                 batches)
    n, steps = steplib.N_SITES // 3, OPTION_STEPS  # 7 dropout sites a D pass
    for label, r in runs.items():
        bf16 = label.startswith("bf16")
        want = {**no_launches(),
                "leaky_relu_dropout_fwd": (3 * n + (2 * n if "remat" in label else 0)) * steps,
                "leaky_relu_dropout_bwd": 3 * n * steps,
                "adam_bf16" if bf16 else "adam": 3 * steps}
        require(r["launches"] == want, f"{label}: launches {r['launches']}, expected {want}")
        require(r["grad_copies"] == 0, f"{label}: {r['grad_copies']} adam gradient copies")
        require(r["moments"] == (["torch.bfloat16"] if bf16 else ["torch.float32"]),
                f"{label}: moments {r['moments']}")
    require(runs["bf16"]["digest"] == runs["bf16_again"]["digest"],
            "bf16 moments: the steps run twice from the seeded state differ")
    require(runs["f32_remat_d"]["digest"] == runs["f32"]["digest"],
            "remat_d (float32 moments): state differs from the run without it")
    require(runs["bf16_remat_d"]["digest"] == runs["bf16"]["digest"],
            "remat_d (bf16 moments): state differs from the run without it")
    require(runs["bf16"]["digest"] != runs["f32"]["digest"], "bf16 moments changed nothing")
    gib = 2.0**30
    for label, r in runs.items():
        log(f"sndcgan {label}: {steps} steps, launches {r['launches']}, peak "
            f"{r['peak_bytes'] / gib:.3f} GiB (state {r['state_bytes'] / gib:.3f} GiB), "
            f"{r['steps_per_sec']:.3f} steps/s over steps 2-{steps} ({card})")
    log("sndcgan options: bf16 moments run twice bit-equal; remat_d bit-equal to the run "
        "without it with float32 and with bf16 moments")
    return {"config": f"{HEIGHT}x{WIDTH} bs{BATCH} base{BASE} SN hinge bf16 d_updates=2",
            "steps": steps, "runs": {label: {k: v for k, v in r.items() if k != "digest"}
                                     for label, r in runs.items()},
            "bit_equal": {"bf16_run_twice": True, "f32_remat_d": True, "bf16_remat_d": True}}


def check_profile_trace(card: str, work: str) -> dict:
    """SNDCGANEngine(profile=True) for two epochs of 2 steps at the headline
    configuration: one trace, of epoch 1, under <dir>/traces, with CUDA
    kernel events among which the dropout kernels' and the Adam kernel's
    (their launches go through ctypes, outside PyTorch's dispatcher)."""
    dev = torch.device("cuda", 0)
    dataset = SyntheticImageDataset(2 * BATCH, (HEIGHT, WIDTH), seed=5)
    out = f"{work}/profiled"
    engine = SNDCGANEngine(out, dataset, BATCH, image_size=(HEIGHT, WIDTH, 3), device=dev,
                           spectral_norm=True, loss="hinge", dtype=torch.bfloat16,
                           base_width=BASE, live_output=f"{work}/live_profiled", profile=True)
    engine.train(2, 10)
    files = sorted(os.listdir(f"{out}/traces"))
    require(files == ["epoch_1.rank0.json"], f"traces {files}, expected epoch_1.rank0.json")
    path = f"{out}/traces/{files[0]}"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    require(kernels, f"{path}: no CUDA kernel events")
    dropout_events = [e for e in kernels if "lrd_" in e["name"]]
    adam_events = [e for e in kernels if "adam_multi_kernel" in e["name"]]
    require(dropout_events, f"{path}: no dropout kernel (lrd_*) events")
    require(adam_events, f"{path}: no Adam kernel (adam_multi_kernel) events")
    steps = engine.num_batches
    record = {
        "trace": "traces/epoch_1.rank0.json", "bytes": os.path.getsize(path),
        "events": len(events), "kernel_events": len(kernels), "steps": steps,
        "dropout_kernel_events": len(dropout_events),
        "dropout_launches": 2 * steplib.N_SITES * steps,
        "adam_kernel_events": len(adam_events), "adam_launches": 3 * steps,
        "kernel_names": sorted({e["name"] for e in dropout_events + adam_events}),
        "device_ms": {"dropout": sum(e["dur"] for e in dropout_events) / 1e3,
                      "adam": sum(e["dur"] for e in adam_events) / 1e3},
        "dropout_ms_per_step": {
            part: sum(e["dur"] for e in dropout_events if f"lrd_{part}" in e["name"]) / 1e3
            / steps for part in ("fwd", "bwd")},
    }
    log(f"profile: {record['trace']} ({record['bytes']:,} bytes, {len(events)} events, "
        f"{len(kernels)} kernel events): {len(dropout_events)} dropout kernel events of "
        f"{record['dropout_launches']} launches, {len(adam_events)} Adam kernel events of "
        f"{record['adam_launches']} launches; names {record['kernel_names']}; dropout ms a "
        f"step {record['dropout_ms_per_step']} ({card})")
    return record


def trace_terms(feats: np.ndarray) -> float:
    """tr(cov) of a feature matrix, in float64."""
    f = feats.astype(np.float64)
    return float(np.sum((f - f.mean(axis=0)) ** 2) / max(f.shape[0] - 1, 1))


def scipy_rounding_bound(feats_fake: np.ndarray, feats_real: np.ndarray) -> float:
    """How far the `scipy` FID (the reference formula: float32 covariances,
    scipy's d x d sqrtm of their product) may sit from the exact lowrank one.
    The product has rank n - 1; each of its d - n + 1 null directions can
    take a float32 rounding eigenvalue of up to EPS32 |C_f| |C_r|, which
    sqrtm lifts to its square root, and the FID counts the trace twice."""
    def top_eigenvalue(f):
        x = f.astype(np.float64)
        x = (x - x.mean(axis=0)) / np.sqrt(x.shape[0] - 1)
        return float(np.linalg.svd(x, compute_uv=False)[0] ** 2)

    n, d = feats_fake.shape
    return 2.0 * (d - n + 1) * math.sqrt(
        EPS32 * top_eigenvalue(feats_fake) * top_eigenvalue(feats_real))


def check_sampling(run: str, dev: torch.device, card: str) -> dict:
    """Both variants of the sampling CLI over the slice's two epochs."""
    args = (3, run, 1, "grid", 0, (HEIGHT, WIDTH, 3), 128, 62)
    kw = dict(device=dev, return_samples=True)
    out = {}
    for name, fn in (("models", generator_output.output_results_models),
                     ("checkpoints", generator_output.output_results_ckpts)):
        t0 = time.perf_counter()
        epochs, samples = fn(*args, **kw)
        out[name] = (epochs, samples, (time.perf_counter() - t0) / len(epochs))
    (epochs_m, from_models, s_m), (epochs_c, from_ckpts, s_c) = out.values()
    require(epochs_m == epochs_c == [0, 1], f"sampled epochs {epochs_m} / {epochs_c}")
    for e, a, b in zip(epochs_m, from_models, from_ckpts):
        require(a.shape == (3, HEIGHT, WIDTH, 3) and bool(np.isfinite(a).all())
                and a.min() >= 0.0 and a.max() <= 1.0, f"samples of epoch {e}")
        require(np.array_equal(a, b), f"epoch {e}: samples from the export and the "
                f"checkpoint differ by {np.abs(a - b).max()}")
    require(not np.array_equal(from_models[0], from_models[1]), "epochs 0 and 1 sample alike")
    log(f"sampling: epochs {epochs_m} from exports and from checkpoints, 3 samples each, "
        f"bit-equal, in [{min(a.min() for a in from_models):.4f}, "
        f"{max(a.max() for a in from_models):.4f}]; {s_m:.3f} s per epoch from exports, "
        f"{s_c:.3f} s from checkpoints (model load included) ({card})")
    return {"epochs": epochs_m, "seconds_per_epoch_exports": s_m,
            "seconds_per_epoch_checkpoints": s_c}


def check_fid(run: str, work: str, dev: torch.device, card: str) -> dict:
    """FIDEvaluator over 16 pinned batches of 32 at 144x256; resume; the
    FIDs again from features taken anew; scipy against lowrank."""
    ds = SyntheticImageDataset(FID_IMAGES, (HEIGHT, WIDTH), seed=4)
    ev = FIDEvaluator(run, f"{work}/fid", (HEIGHT, WIDTH, 3), spectral_norm=True,
                      device=dev)
    t0 = time.perf_counter()
    results = ev.evaluate(dataset=ds, batch_size=BATCH, start_epoch=0)
    total = time.perf_counter() - t0
    pin_s, epoch_s = ev.pin_seconds, dict(ev.epoch_seconds)
    init = ev.load_init()
    require(init["batches_used"] == MAX_BATCHES and init["disc_epoch"] == 1
            and all(x.shape == (BATCH, HEIGHT, WIDTH, 3) for x in init["img_real_used"]),
            f"pinned {init['batches_used']} batches, disc epoch {init['disc_epoch']}")
    require(sorted(results) == [0, 1] and all(len(v) == MAX_BATCHES for v in results.values()),
            f"fids {results}")

    real = [ev.features(x) for x in init["img_real_used"]]
    th, tw = trunk_hw((HEIGHT, WIDTH))
    n_feats = DISC_TRUNK[-1][0] * (th // 8) * (tw // 8)  # 4096 at 144x256
    require(real[0].shape == (BATCH, n_feats), f"feature shape {real[0].shape}")
    worst_floor, worst_again, fake = 0.0, 0.0, {}
    for e in results:
        ev.load_gen(e)
        fake[e] = [ev.fake_features(torch.from_numpy(z).to(dev)).cpu().numpy()
                   for z in init["random_z_used"]]
        for b, (ff, rf) in enumerate(zip(fake[e], real)):
            fid, scale = results[e][b], trace_terms(ff) + trace_terms(rf)
            require(math.isfinite(fid) and fid >= -FID_FLOOR * scale,
                    f"epoch {e} batch {b}: FID {fid} (trace terms {scale})")
            worst_floor = min(worst_floor, fid / scale)
            again = calculate_fid_from_features(ff, rf)
            worst_again = max(worst_again, abs(again - fid) / scale)
            require(abs(again - fid) <= FID_FLOOR * scale,
                    f"epoch {e} batch {b}: FID {fid}, from features taken anew {again}")

    results_file = f"{work}/fid/fids.pickle"
    require(ev.evaluate(continue_=True) == results and ev.epoch_seconds == {},
            "a resumed evaluation computed again")
    with open(results_file, "rb") as f:
        kept = pickle.load(f)
    del kept[0]
    with open(results_file, "wb") as f:
        pickle.dump(kept, f)
    resumed = ev.evaluate(continue_=True)
    require(sorted(ev.epoch_seconds) == [0], f"resume recomputed {sorted(ev.epoch_seconds)}")
    diff = max(abs(a - b) for a, b in zip(resumed[0], results[0]))
    require(diff <= FID_FLOOR * max(trace_terms(rf) for rf in real),
            f"epoch 0 again differs by {diff}")
    log(f"fid: {MAX_BATCHES} pinned batches of {BATCH} at {WIDTH}x{HEIGHT}, {n_feats} features, "
        f"epochs {sorted(results)}, disc epoch 1: means "
        f"{[round(float(np.mean(results[e])), 4) for e in sorted(results)]}, "
        f"min FID / trace terms {worst_floor:.3g} (floor {-FID_FLOOR}), features anew within "
        f"{worst_again:.3g} of the trace terms; resume computed nothing, a dropped epoch "
        f"came back {'bit-equal' if diff == 0 else f'within {diff:.3g}'}")
    log(f"fid timing: pinning {pin_s:.3f} s; per epoch export load "
        + ", ".join(f"{t['load']:.3f}" for t in epoch_s.values())
        + " s, features (synthesis included) "
        + ", ".join(f"{t['features']:.3f}" for t in epoch_s.values())
        + " s, FID math " + ", ".join(f"{t['fid']:.3f}" for t in epoch_s.values())
        + f" s; evaluate() {total:.3f} s in all ({card})")

    # scipy's d x d sqrtm on the first two pinned batches of the last epoch
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        sp = list(pool.map(
            lambda b: calculate_fid_from_features(fake[1][b], real[b], "scipy"), range(2)))
    scipy_s = time.perf_counter() - t0
    gaps = []
    for b in range(2):
        gap, tol = abs(sp[b] - results[1][b]), scipy_rounding_bound(fake[1][b], real[b])
        scale = trace_terms(fake[1][b]) + trace_terms(real[b])
        gaps.append({"gap": gap, "bound": tol, "trace_terms": scale})
        require(gap <= tol, f"batch {b}: scipy {sp[b]} vs lowrank {results[1][b]}: "
                f"{gap} beyond the float32 rounding bound {tol}")
    log(f"fid: scipy vs lowrank on pinned batches 0-1 of epoch 1: {sp} vs {results[1][:2]}; "
        + "; ".join(f"gap {g['gap']:.4g} (bound {g['bound']:.4g}, "
                    f"{g['gap'] / g['trace_terms']:.3g} of the trace terms)" for g in gaps)
        + f"; {scipy_s:.1f} s on the host")
    return {"batches": MAX_BATCHES, "batch": BATCH, "features": n_feats,
            "fid_means": {e: float(np.mean(v)) for e, v in results.items()},
            "pin_seconds": pin_s, "epoch_seconds": epoch_s, "evaluate_seconds": total,
            "scipy_vs_lowrank": gaps, "scipy_seconds": scipy_s}


def check_newton_schulz(dev: torch.device) -> float:
    from scipy.linalg import sqrtm

    r = np.random.default_rng(8).standard_normal((512, 512))
    a = r @ r.T / 512 + np.eye(512)  # SPD, eigenvalues in [1, 5]
    want = sqrtm(a).real
    got = sqrtm_newton_schulz(torch.from_numpy(a.astype(np.float32)).to(dev)).double().cpu()
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    require(err <= NS_TOL, f"Newton–Schulz vs scipy sqrtm: {err}")
    log(f"Newton–Schulz on the card (n 512, SPD, float32, TF32 off) vs scipy.linalg.sqrtm: "
        f"max abs err {err:.3g} of the largest entry (bound {NS_TOL})")
    return err


def check_image_folder(run: str, work: str, dev: torch.device, card: str) -> dict:
    """A folder of JPEG and PNG files written here with cv2, read through
    ImageFolderDataset, then through the FID CLI's evaluate_fid."""
    import cv2

    folder = f"{work}/images"
    os.makedirs(f"{folder}/landscape")
    rng = np.random.default_rng(11)
    smooth = cv2.resize(rng.integers(0, 256, (3, 4, 3), dtype=np.uint8), (WIDTH, HEIGHT),
                        interpolation=cv2.INTER_LINEAR)  # JPEG keeps smooth images close
    exact = {}
    for i, (h, w) in enumerate(((HEIGHT, WIDTH), (200, 300), (300, 200))):
        img = smooth if i == 0 else rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for ext in ("png", "jpg"):
            require(cv2.imwrite(f"{folder}/landscape/i{i}.{ext}",
                                np.ascontiguousarray(img[..., ::-1])),
                    f"cv2.imwrite i{i}.{ext}")
        exact[i] = img
    t0 = time.perf_counter()
    ds = ImageFolderDataset(folder, (HEIGHT, WIDTH))
    read_s = time.perf_counter() - t0
    require(ds.decoders == {"cv2": 6}, f"decoders {ds.decoders}")
    names = [p.name for p in ds.files]
    png, jpg = ds.images[names.index("i0.png")], ds.images[names.index("i0.jpg")]
    require(np.array_equal(png, exact[0]), "the PNG at the target size did not decode exactly")
    jpg_err = float(np.abs(jpg.astype(np.int32) - exact[0]).mean())
    require(jpg_err <= 4.0, f"the JPEG decodes {jpg_err} grey levels off on average")
    log(f"image folder: 3 PNG + 3 JPEG written with cv2 {cv2.__version__}, read through "
        f"ImageFolderDataset into {ds.images.shape} uint8 in {read_s:.3f} s, decoders "
        f"{ds.decoders}; PNG exact, JPEG mean abs err {jpg_err:.3f} ({card})")
    results = generator_evaluation.evaluate_fid(
        run, folder, 2, f"{work}/xfid", 1, 0, 1, False, (HEIGHT, WIDTH, 3),
        spectral_norm=True, device=dev)
    require(sorted(results) == [0, 1] and all(
        len(v) == 3 and all(map(math.isfinite, v)) for v in results.values()),
        f"evaluate_fid over the folder: {results}")
    log(f"image folder through generator_evaluation.evaluate_fid at batch 2: 3 pinned "
        f"batches, FIDs {results}")
    return {"decoders": ds.decoders, "cv2": cv2.__version__, "jpeg_mean_abs_err": jpg_err,
            "read_seconds": read_s}


def run_sampling_and_fid(card: str, work: str, dev: torch.device) -> dict:
    """Phase 6 on the SNDCGAN slice's directory: no hand kernel may run."""
    run = f"{work}/sndcgan"
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"sampling": check_sampling(run, dev, card), "fid": check_fid(run, work, dev, card),
           "newton_schulz_err": check_newton_schulz(dev),
           "image_folder": check_image_folder(run, work, dev, card)}
    launches = read_launches()
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    require(set(launches.values()) == {0}, f"hand kernels launched in sampling/FID: {launches}")
    log(f"sampling and FID: launches {launches}; peak allocated "
        f"{out['peak_allocated_bytes'] / 2**30:.2f} GiB ({card})")
    out["launches"] = launches
    return out


def check_instance_norm_eval_batch(card: str) -> dict:
    """The InstanceNorm forward kernel against its plain version at the
    CycleGAN norm shapes at the PD batch (128), float32, ReLU off and on
    (the tolerance of check_instance_norm); timed at the largest with the
    L2 flushed against the plain version and F.instance_norm."""
    dev = torch.device("cuda", 0)
    max_err, flips, flip_max = 0.0, 0, 0.0
    for shape in IN_EVAL_SHAPES:
        x, _, gamma, beta = in_inputs(dev, shape, torch.float32)
        for relu in (False, True):
            at = f"{shape} f32 relu={relu}"
            y, mean, rstd = inorm.in_fwd_kernel(x, gamma, beta, EPS, relu)
            yp, meanp, rstdp = inorm.in_fwd_plain(x, gamma, beta, EPS, relu)
            max_err = max(max_err, in_close(f"fwd y {at}", y, yp, 2e-5),
                          in_close(f"fwd mean {at}", mean, meanp, 1e-5),
                          in_close(f"fwd rstd {at}", rstd, rstdp, 1e-5))
            if relu:
                # Over 2**27 elements a few pre-ReLU values round to either
                # side of 0: the pattern may differ only within the atol.
                differ = (y == 0) != (yp == 0)
                flips += int(differ.sum())
                flip_max = max(flip_max, float(torch.where(differ, y + yp, 0).max()))
                require(flip_max <= 2e-5, f"fwd zero pattern {at}: a flip at {flip_max}")
            del y, yp
        del x
    torch.cuda.synchronize()
    log(f"instance norm forward kernel at the {len(IN_EVAL_SHAPES)} norm shapes at batch "
        f"{PD_IMAGES}: within tolerance, f32, relu off/on, max abs err {max_err:.3g}; ReLU "
        f"zero pattern: {flips} elements differ, each within {flip_max:.3g} of 0")
    x, _, gamma, beta = in_inputs(dev, IN_EVAL_TIMED, torch.float32)
    n = x.numel()
    flush = L2Flush(dev)
    times = timing(lambda: inorm.in_fwd_kernel(x, gamma, beta, EPS, False),
                   lambda: inorm.in_fwd_plain(x, gamma, beta, EPS, False),
                   in_plans_tool.library_fwd(x, gamma, beta), flush=flush)
    del flush, x
    b, c, h, w = IN_EVAL_TIMED
    rec = {"shape_nchw": list(IN_EVAL_TIMED), "dtype": "float32", **times,
           "checked_shapes_nchw": [list(s) for s in IN_EVAL_SHAPES], "max_abs_err": max_err,
           "relu_zero_pattern_flips": flips, "relu_flip_max_value": flip_max,
           # read x, gamma, beta, write y, mean, rstd; ~10 operations per element
           **bound(4 * (2 * n + 2 * b * c + 2 * c), 10 * n),
           "plans_f32": {str(s): in_plans(s)["fwd"] for s in IN_EVAL_SHAPES}}
    plan = rec["plans_f32"][str(IN_EVAL_TIMED)]
    log(f"instance_norm_fwd at {IN_EVAL_TIMED} f32 device time, L2 flushed (warm): kernel "
        f"{times['ms']:.4f} ({times['warm_ms']:.4f}) ms, plain {times['plain_ms']:.4f} "
        f"({times['plain_warm_ms']:.4f}) ms, F.instance_norm {times['library_ms']:.4f} "
        f"({times['library_warm_ms']:.4f}) ms, bound {rec['bound_ms']:.4f} ms; plan "
        f"{plan['ctas']} CTAs, cluster {plan['cluster']}, held {plan['held']} "
        f"({plan['smem_bytes']} B shared) ({card})")
    return rec


def write_pd_samples(folder: str) -> None:
    """PD_IMAGES synthetic 128x128 uint8 images as PNG files, with cv2."""
    import cv2

    os.makedirs(folder)
    images = SyntheticImageDataset(PD_IMAGES, (CG_SIZE, CG_SIZE), seed=12).images
    for i, img in enumerate(images):
        require(cv2.imwrite(f"{folder}/s{i:03d}.png", np.ascontiguousarray(img[..., ::-1])),
                f"cv2.imwrite s{i:03d}.png")


def pd_on_cpu(export: str, samples: str, n: int) -> np.ndarray:
    """The PDs of the first `n` pairs of the CLI's batch, on the CPU, with
    the CLI's models (the random-init VGG16)."""
    cpu = torch.device("cpu")
    ds = ImageFolderDataset(samples, (CG_SIZE, CG_SIZE), labeled=False)
    x = torch.from_numpy(ds.images[ds.permutation(0)[:n]]).float() / 127.5 - 1.0
    gen = CycleGANGenerator(CycleGANConfig(), torch.Generator()).eval()
    bridge.load_flax_variables(gen, load_params(export))
    with torch.no_grad():
        out = gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return pdlib.make_pd_fn(pdlib.load_vgg16_params(device=cpu))(x, out).numpy()


def check_pd_cli(work: str, dev: torch.device, card: str) -> dict:
    """The PD CLI on each generator directory of the CycleGAN run: 2
    epochs of PD_IMAGES PDs, exact launch counts; PD(x, x) = 0; two pairs
    again on the CPU."""
    samples = f"{work}/pd_samples"
    write_pd_samples(samples)
    out = {"launches": dict.fromkeys(read_launches(), 0), "by_generator": {}}
    for name in ("g", "f"):
        gens = f"{work}/cyclegan/models/generator_{name}"
        zero_launches()
        t0 = time.perf_counter()
        epochs, pds, seconds = cyclegan_evaluation.main(
            [gens, samples, "-s", str(PD_IMAGES), "-o", f"{work}/pd_{name}"])
        total = time.perf_counter() - t0
        launches = read_launches()
        for k, v in launches.items():
            out["launches"][k] += v
        require(epochs == [0, 1], f"generator_{name}: epochs {epochs}")
        for e, p in zip(epochs, pds):
            require(len(p) == PD_IMAGES and all(math.isfinite(v) and v > 0 for v in p),
                    f"generator_{name} epoch {e}: {len(p)} PDs, finite and > 0: "
                    f"{all(map(math.isfinite, p))}")
        want = dict.fromkeys(launches, 0)
        want["instance_norm_fwd"] = IN_PER_TRANSLATION * len(epochs)
        require(launches == want, f"generator_{name}: launches {launches}, expected {want}")
        cpu = pd_on_cpu(f"{gens}/gen_weights_{name}-1.msgpack", samples, 2)
        gap = float(np.max(np.abs(cpu - np.asarray(pds[1][:2])) / np.abs(cpu)))
        require(gap <= EVAL_RTOL, f"generator_{name} epoch 1: card PDs {pds[1][:2]} vs CPU "
                f"{cpu.tolist()} ({gap:.3g} relative, bound {EVAL_RTOL})")
        out["by_generator"][name] = {
            "epochs": epochs, "pd_means": [float(np.mean(p)) for p in pds],
            "epoch_seconds": seconds, "main_seconds": total, "card_vs_cpu_rel": gap}
        log(f"pd cli on generator_{name}: epochs {epochs}, {PD_IMAGES} PDs each, means "
            f"{[round(float(np.mean(p)), 6) for p in pds]}; launches {launches}; pairs 0-1 "
            f"of epoch 1 on the CPU within {gap:.3g} relative (bound {EVAL_RTOL})")
        log(f"pd timing, generator_{name}: per epoch export load "
            + ", ".join(f"{t['load']:.4f}" for t in seconds)
            + f" s, features (translation, 2 x {PD_IMAGES} VGG16 at 224) "
            + ", ".join(f"{t['features']:.3f}" for t in seconds)
            + " s, math " + ", ".join(f"{t['math']:.4f}" for t in seconds)
            + f" s; main() {total:.3f} s in all ({card})")

    ds = ImageFolderDataset(samples, (CG_SIZE, CG_SIZE), labeled=False)
    x = torch.from_numpy(ds.images[ds.permutation(0)]).to(dev).float() / 127.5 - 1.0
    same = pdlib.make_pd_fn(pdlib.load_vgg16_params(device=dev))(x, x)
    require(bool((same == 0).all()), f"PD(x, x) up to {same.abs().max().item()}")
    log(f"pd: PD(x, x) exactly 0 over the {PD_IMAGES} images on the card (deterministic cuDNN)")
    return out


def check_inception_fid(run: str, work: str, dev: torch.device, card: str) -> dict:
    """FIDEvaluator with the Inception features over the SNDCGAN run, 16
    pinned batches of 32 at 144x256; resume; card against CPU features."""
    ds = SyntheticImageDataset(FID_IMAGES, (HEIGHT, WIDTH), seed=4)
    out_dir = f"{work}/inception_fid"
    zero_launches()
    ev = FIDEvaluator(run, out_dir, (HEIGHT, WIDTH, 3), spectral_norm=True,
                      feature_source="inception", device=dev)
    t0 = time.perf_counter()
    results = ev.evaluate(dataset=ds, batch_size=BATCH, start_epoch=0)
    total = time.perf_counter() - t0
    pin_s, epoch_s = ev.pin_seconds, dict(ev.epoch_seconds)
    require(sorted(results) == [0, 1] and all(len(v) == MAX_BATCHES for v in results.values()),
            f"inception fids {results}")
    for e, fids in results.items():
        require(all(math.isfinite(v) and v >= 0 for v in fids), f"epoch {e}: FIDs {fids}")
    require(ev.evaluate(continue_=True) == results and ev.epoch_seconds == {},
            "a resumed inception evaluation computed again")
    results_file = f"{out_dir}/fids.pickle"
    with open(results_file, "rb") as f:
        kept = pickle.load(f)
    del kept[0]
    with open(results_file, "wb") as f:
        pickle.dump(kept, f)
    again = ev.evaluate(continue_=True)
    launches = read_launches()
    require(sorted(ev.epoch_seconds) == [0], f"resume recomputed {sorted(ev.epoch_seconds)}")
    diff = max(abs(a - b) for a, b in zip(again[0], results[0]))
    require(diff <= 1e-6 * max(map(abs, results[0])),
            f"epoch 0 again: {again[0]} vs {results[0]}")
    require(set(launches.values()) == {0}, f"hand kernels launched in the inception FID: "
            f"{launches}")

    images = ev.load_init()["img_real_used"][0][:2]
    card_feats = ev.features(images)
    cpu_model = inception.load_inception_params(device="cpu")
    cpu_feats = inception.make_feature_fn(cpu_model)(torch.from_numpy(images)).numpy()
    err = float(np.abs(card_feats - cpu_feats).max() / np.abs(cpu_feats).max())
    require(card_feats.shape == (2, 2048) and err <= EVAL_RTOL,
            f"inception features card vs CPU: {err:.3g} of the largest (bound {EVAL_RTOL})")
    log(f"inception fid: {MAX_BATCHES} pinned batches of {BATCH} at {WIDTH}x{HEIGHT}, 2048 "
        f"features, epochs {sorted(results)}: means "
        f"{[round(float(np.mean(results[e])), 4) for e in sorted(results)]}, min "
        f"{min(min(v) for v in results.values()):.4g}; resume computed nothing, a dropped "
        f"epoch came back {'bit-equal' if diff == 0 else f'within {diff:.3g}'}; launches {launches}; 2 images' features on the CPU "
        f"within {err:.3g} of the largest (bound {EVAL_RTOL})")
    log(f"inception fid timing: pinning {pin_s:.3f} s; per epoch export load "
        + ", ".join(f"{t['load']:.3f}" for t in epoch_s.values())
        + " s, features (synthesis and Inception at 299) "
        + ", ".join(f"{t['features']:.3f}" for t in epoch_s.values())
        + " s, FID math " + ", ".join(f"{t['fid']:.3f}" for t in epoch_s.values())
        + f" s; evaluate() {total:.3f} s in all ({card})")
    return {"launches": launches, "fid_means": {e: float(np.mean(v)) for e, v in results.items()},
            "pin_seconds": pin_s, "epoch_seconds": epoch_s, "evaluate_seconds": total,
            "card_vs_cpu_features_err": err}


def run_evaluation(card: str, work: str, dev: torch.device, kernels: list[dict]) -> dict:
    """Phase 7: the InstanceNorm forward at batch 128, then the PD CLI and
    the Inception FID; their launches summed as the evaluation path's."""
    at_batch = check_instance_norm_eval_batch(card)
    next(k for k in kernels if k["name"] == "instance_norm_fwd")["at_pd_batch"] = at_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pd_rec = check_pd_cli(work, dev, card)
    fid_rec = check_inception_fid(f"{work}/sndcgan", work, dev, card)
    seconds = time.perf_counter() - t0
    launches = {k: pd_rec["launches"][k] + fid_rec["launches"][k] for k in pd_rec["launches"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"evaluation: launches {launches}; peak allocated {peak / 2**30:.2f} GiB; "
        f"{seconds:.1f} s ({card})")
    return {"pd": pd_rec, "inception_fid": fid_rec, "launches": launches,
            "peak_allocated_bytes": peak, "seconds": seconds,
            "instance_norm_fwd_at_pd_batch": {k: at_batch[k] for k in (
                "ms", "warm_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


# ------------------------------------------------------------------ phase 8
def check_dropout_base(dev: torch.device, card: str) -> dict:
    """Phase 8a: at every distinct D site shape, bf16 and f32, forward and
    backward, the kernel on rank r's rows [r*b, (r+1)*b) of the global batch
    with base r*b*H*W*C is bit-equal to those rows of the full-batch kernel
    and to the plain version with that base; timed on rank 1's rows of the
    largest site (bf16)."""
    kw = KeyChain(7).dropout_kw(torch.zeros((), dtype=torch.int64, device=dev), 1)[0]
    cut = dropout.dropout_cut(0.5)
    b = BATCH // DP_WORLD
    n_checked = 0
    for shape in disc_site_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(sum(shape) + 1)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = g.contiguous(memory_format=torch.channels_last)
            full_y = dropout.fwd_kernel(x, kw, cut)
            full_dx = dropout.bwd_kernel(x, g, kw, cut)
            total = x.numel()
            for r in range(DP_WORLD):
                rows = slice(r * b, (r + 1) * b)
                xr, gr = x[rows], g[rows]
                base = dropout.rows_base(x, r * b)
                at = f"{shape} {dtype} rank {r}"
                y = dropout.fwd_kernel(xr, kw, cut, base, total)
                dx = dropout.bwd_kernel(xr, gr, kw, cut, base, total)
                require(torch.equal(y, full_y[rows]), f"dropout fwd with base {at}: "
                        "differs from the full batch's rows")
                require(torch.equal(dx, full_dx[rows]), f"dropout bwd with base {at}: "
                        "differs from the full batch's rows")
                require(torch.equal(y, dropout.fwd_plain(xr, kw, cut, base)),
                        f"dropout fwd with base {at}: differs from plain")
                require(torch.equal(dx, dropout.bwd_plain(xr, gr, kw, cut, base)),
                        f"dropout bwd with base {at}: differs from plain")
                n_checked += 4
    shape = disc_site_shapes()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    xr, gr = x[b:], g[b:]
    base, total = dropout.rows_base(x, b), x.numel()
    fwd = timing(lambda: dropout.fwd_kernel(xr, kw, cut, base, total),
                 lambda: dropout.fwd_plain(xr, kw, cut, base))
    bwd = timing(lambda: dropout.bwd_kernel(xr, gr, kw, cut, base, total),
                 lambda: dropout.bwd_plain(xr, gr, kw, cut, base))
    log(f"phase 8a: dropout kernels with an index base: {n_checked} rank slices at "
        f"{len(disc_site_shapes())} site shapes, bf16 and f32, bit-equal to the full "
        f"batch's rows and to the plain version; rank 1's rows of {shape} (bf16): "
        f"fwd {fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}), bwd {bwd['ms']:.4f} ms "
        f"(plain {bwd['plain_ms']:.4f}) device time ({card})")
    return {"checked": n_checked, "timed_shape_nchw": [b, *shape[1:]], "fwd": fwd, "bwd": bwd}


def dp_engine_config() -> dict:
    """The headline SNDCGAN configuration of phase 8's engine runs."""
    return dict(height=HEIGHT, width=WIDTH, batch=BATCH, base=BASE, dtype=torch.bfloat16,
                epoch_batches=DP_EPOCH_BATCHES)


def count_writes() -> dict[str, int]:
    """Count, in this process, the engines' artifact writes by kind: the
    returned dict is updated by every checkpoint save, export, loss-history
    save and perf.jsonl line from here on."""
    writes = {"checkpoint": 0, "export": 0, "losses": 0, "perf": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            writes[name] += 1
            return fn(*a, **k)
        return wrapped

    ckptlib.CheckpointManager.save = counting("checkpoint", ckptlib.CheckpointManager.save)
    ckptlib.export_params = counting("export", ckptlib.export_params)
    metricslib.LossHistory.save = counting("losses", metricslib.LossHistory.save)
    metricslib.write_metrics_jsonl = counting("perf", metricslib.write_metrics_jsonl)
    return writes


def dp_engine_rank(group, out: str, phases, small_jobs, ecfg: dict) -> dict:
    """One rank of phase 8b/8c: SNDCGANEngine at the configuration `ecfg`
    (dp_engine_config), `phases` of (epochs, continue_), with the launch and
    collective counts, the state digest and which artifacts this rank
    wrote; then the small float32 steps of `small_jobs` (tools/dp_parity)."""
    writes = count_writes()
    hw = (ecfg["height"], ecfg["width"])
    dataset = SyntheticImageDataset(ecfg["epoch_batches"] * ecfg["batch"], hw)
    kwargs = dict(image_size=(*hw, 3), device=group.device, spectral_norm=True,
                  loss="hinge", dtype=ecfg["dtype"], base_width=ecfg["base"],
                  live_output=f"{out}/live", mesh=group)
    results = []
    for epochs, cont in phases:
        engine = SNDCGANEngine(f"{out}/sndcgan", dataset, ecfg["batch"], continue_=cont,
                               **kwargs)
        start = engine.start_epoch
        zero_launches()
        before = dict(group.counts)
        torch.cuda.synchronize(group.device)
        t0 = time.perf_counter()
        engine.train(epochs, 1)
        torch.cuda.synchronize(group.device)
        seconds = time.perf_counter() - t0
        perf = None
        if group.is_main:  # the engine's own rate of the epoch (rank 0 writes perf.jsonl)
            with open(f"{out}/sndcgan/perf.jsonl") as f:
                perf = json.loads(f.read().splitlines()[-1])
        results.append({
            "start": start, "steps": engine.num_batches * (epochs - start),
            "seconds": seconds, "perf": perf, "launches": read_launches(),
            "grad_copies": adam.GRAD_COPIES["adam"],
            "collectives": {k: group.counts[k] - before[k] for k in before},
            "digest": engine.last_digest, "metrics": engine.last_epoch_metrics,
            "resident": engine.resident})
        del engine
    small = {name: dp_parity.run_steps(group, family, cfg, inputs, init)
             for name, family, cfg, inputs, init in small_jobs}
    return {"rank": group.rank, "backend": group.backend, "device": str(group.device),
            "phases": results, "writes": writes, "small": small}


def small_dp_jobs() -> list[tuple]:
    """The small float32 steps of phase 8b: (name, family, config, global
    inputs, initial state or None); WGAN's replay a one-process trajectory
    step by step, so their initial states are filled in later."""
    gen = np.random.default_rng(8)
    im = (32, 48, 3)
    snd = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=im, base_width=32, spectral_norm=True),
        batch_size=4, loss="hinge")
    jobs = [("sndcgan", "sndcgan", snd, {
        "batches": gen.integers(0, 256, (2, 4, *im), np.uint8),
        "z": gen.uniform(-1, 1, (2, 4, 128)).astype(np.float32),
        "kw": gen.integers(0, 2**32, (steplib.N_SITES, 2)).astype(np.int64)}, None)]
    wgan_in = {"batches": gen.integers(0, 256, (4, 4, *im), np.uint8),
               "z_fake": gen.normal(size=(4, 4, 128)).astype(np.float32),
               "z_gan": gen.normal(size=(4, 4, 128)).astype(np.float32)}
    for name, gp in (("wgan_clip", 0.0), ("wgan_gp", 10.0)):
        cfg = wgan_step.WGANTrainConfig(model=WGANConfig(image_size=im, base_width=16),
                                        batch_size=4, n_critic=2, gp_lambda=gp)
        inputs = dict(wgan_in)
        if gp:
            inputs["gp_eps"] = gen.uniform(size=(4, 4, 1, 1, 1)).astype(np.float32)
        jobs.append((name, "wgan", cfg, inputs, None))
    cyc = cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=(96, 96, 3), base_width=8, n_res_blocks=2),
        batch_size=2)
    jobs.append(("cyclegan", "cyclegan", cyc, {
        "batches_x": gen.integers(0, 256, (2, 2, 96, 96, 3), np.uint8),
        "batches_y": gen.integers(0, 256, (2, 2, 96, 96, 3), np.uint8)}, None))
    return jobs


def small_dp_errors(got: dict, want: dict) -> dict:
    """How far a small 2-rank run (tools/dp_parity) is from the one-process
    run: the worst metric error relative to max(1, |v|); and per state
    collection (a model's parameters, its BatchNorm statistics, each
    optimizer moment) of each step's state, the largest error over the
    collection's largest |v| (a moment off by the world size reads ~1 or
    more; a leaf whose gradient is rounding noise, a conv bias before a
    norm, is weighed against its collection, not against itself). Also
    where each is, and the largest metric |v|."""
    out = {"metric": 0.0, "metric_at": None, "leaf": 0.0, "leaf_at": None, "max_abs_metric": 0.0}
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        for k, v in b.items():
            d = abs(a[k] - v) / max(1.0, abs(v)) if math.isfinite(a[k]) else math.inf
            out["max_abs_metric"] = max(out["max_abs_metric"], abs(v))
            if d >= out["metric"]:
                out["metric"], out["metric_at"] = d, f"step {i} {k}"
    for i, (sa, sb) in enumerate(zip(got["states"], want["states"])):
        leaves_a = dict(dp._leaves(sa))
        diff: dict[str, float] = {}
        scale: dict[str, float] = {}
        for path, b in dp._leaves(sb):
            parts = path.strip("/").split("/")
            coll = "/".join(parts[:2] if parts[0].endswith("_opt") else parts[:1])
            a = np.asarray(leaves_a[path], np.float64)
            b = np.asarray(b, np.float64)
            d = float(np.abs(a - b).max()) if np.isfinite(a).all() else math.inf
            diff[coll] = max(diff.get(coll, 0.0), d)
            scale[coll] = max(scale.get(coll, 0.0), float(np.abs(b).max()))
        for coll, d in diff.items():
            rel = d / scale[coll] if scale[coll] else (math.inf if d else 0.0)
            if rel >= out["leaf"]:
                out["leaf"], out["leaf_at"] = rel, f"step {i} /{coll}"
    return out


def check_dp_engine_ranks(ranks: list[dict], label: str, card: str, ecfg: dict) -> dict:
    """Per rank: exact launch counts (dropout 21 + 21, Adam 3 and 3 gradient
    all-reduces per step), no Adam gradient copy, bit-equal digests after
    each phase, artifacts from rank 0 only."""
    for p in range(len(ranks[0]["phases"])):
        digests = {r["phases"][p]["digest"] for r in ranks}
        require(len(digests) == 1, f"{label} phase {p}: rank digests differ")
        for r in ranks:
            ph = r["phases"][p]
            steps = ph["steps"]
            want = {**no_launches(), "leaky_relu_dropout_fwd": steplib.N_SITES * steps,
                    "leaky_relu_dropout_bwd": steplib.N_SITES * steps, "adam": 3 * steps}
            require(ph["launches"] == want,
                    f"{label} rank {r['rank']} phase {p}: launches {ph['launches']}, "
                    f"expected {want}")
            require(ph["grad_copies"] == 0, f"{label}: adam gradient copies {ph['grad_copies']}")
            require(ph["collectives"]["grad_all_reduce"] == 3 * steps,
                    f"{label} rank {r['rank']}: {ph['collectives']} for {steps} steps")
            require(ph["start"] == p and all(math.isfinite(v) for v in ph["metrics"].values()),
                    f"{label} rank {r['rank']} phase {p}: start {ph['start']}, {ph['metrics']}")
    require(all(v > 0 for v in ranks[0]["writes"].values()), f"{label}: rank 0 wrote "
            f"{ranks[0]['writes']}")
    for r in ranks[1:]:
        require(set(r["writes"].values()) == {0}, f"{label}: rank {r['rank']} wrote {r['writes']}")
    perf = ranks[0]["phases"][-1]["perf"]
    rate = perf["steps_per_sec"]
    log(f"{label}: backend {ranks[0]['backend']}, {len(ranks)} rank(s) on "
        f"{sorted({r['device'] for r in ranks})}, {ecfg['width']}x{ecfg['height']} global "
        f"batch {ecfg['batch']} ({ecfg['batch'] * ecfg.get('spatial', 1) // len(ranks)} rows "
        f"and 1/{ecfg.get('spatial', 1)} of the image rows per rank) base {ecfg['base']} "
        f"SN hinge {ecfg['dtype']}; per rank and step: "
        f"dropout {steplib.N_SITES}+{steplib.N_SITES}, adam 3, 3 gradient all-reduces, "
        f"0 gradient copies; digests equal after each epoch; artifacts from rank 0 only "
        f"{ranks[0]['writes']}; last epoch {rate:.3f} steps/s, {perf['images_per_sec']:.1f} "
        f"global images/s (the engine's perf.jsonl; ranks sharing a card are no speed-up "
        f"claim) ({card})")
    return {"ranks": len(ranks), "backend": ranks[0]["backend"],
            "devices": sorted({r["device"] for r in ranks}),
            "last_epoch_steps_per_sec": rate, "last_epoch_images_per_sec": perf["images_per_sec"],
            "last_epoch_wall_seconds_with_checkpoint": ranks[0]["phases"][-1]["seconds"],
            "launches_rank0": {k: sum(ph["launches"][k] for ph in ranks[0]["phases"])
                               for k in ranks[0]["phases"][0]["launches"]},
            "collectives_rank0": ranks[0]["phases"][-1]["collectives"]}


def run_data_parallel(card: str, work: str, dev: torch.device) -> dict:
    """Phase 8: (a) the dropout kernels with an index base; (b) two ranks on
    this one card over gloo, named explicitly (gloo reduces CUDA tensors
    through the host; NCCL runs one rank per card): SNDCGANEngine at the
    headline configuration, then small float32 2-rank steps held to the
    one-process steps on the card; (c) two cards over NCCL where the machine
    has them, and a world-1 NCCL group through the engine either way."""
    t0 = time.perf_counter()
    ecfg = dp_engine_config()
    torch.cuda.empty_cache()
    dropout_base = check_dropout_base(dev, card)
    jobs = small_dp_jobs()
    one = {}
    for i, (name, family, cfg, inputs, _) in enumerate(jobs):
        one[name] = dp_parity.run_steps(None, family, cfg, inputs, device=str(dev))
        if family == "wgan":  # replay the one-process trajectory step by step
            replay = [one[name]["state0"]] + one[name]["states"][:-1]
            jobs[i] = (name, family, cfg, inputs, replay)
    torch.cuda.empty_cache()
    phases = [(1, False), (2, True)]
    ranks = dp.spawn_local(dp_engine_rank, DP_WORLD, backend="gloo",
                           devices=[str(dev)] * DP_WORLD, timeout=DP_RANKS_TIMEOUT_S,
                           args=(f"{work}/dp_gloo", phases, jobs, ecfg))
    shared = check_dp_engine_ranks(ranks, "phase 8b (2 ranks sharing one card)", card, ecfg)
    worst, families = {}, {name: family for name, family, *_ in jobs}
    for name, want in one.items():
        got = [r["small"][name] for r in ranks]
        require(got[0]["digest"] == got[1]["digest"], f"small 2-rank {name}: digests differ")
        # the WGAN path has no hand kernel; the others launch theirs
        require(got[0]["launches"] == got[1]["launches"] == want["launches"]
                and any(want["launches"].values()) != name.startswith("wgan"),
                f"small 2-rank {name}: launches {got[0]['launches']}, one process "
                f"{want['launches']}")
        err = small_dp_errors(got[0], want)
        bounds = DP_STEP_BOUND[families[name]]
        for what, bound_rel in zip(("metric", "leaf"), bounds):
            require(err[what] <= bound_rel, f"small 2-rank {name}: {what} error "
                    f"{err[what]} at {err[what + '_at']} past {bound_rel}")
        worst[name] = err
    log(f"phase 8b: small float32 2-rank steps against the one-process steps on the card "
        f"(SNDCGAN SN hinge with dropout 2 steps, WGAN clip and GP 4 steps each from the "
        f"one-process state before it, CycleGAN 2 steps): {worst} (bounds (metric, leaf) "
        f"{DP_STEP_BOUND}), rank digests equal, each rank's kernel launches those of one "
        f"process")
    two_cards = None
    if torch.cuda.device_count() >= 2:
        two = dp.spawn_local(dp_engine_rank, 2, "cuda", backend="nccl",
                             timeout=DP_RANKS_TIMEOUT_S,
                             args=(f"{work}/dp_nccl2", phases, [], ecfg))
        two_cards = check_dp_engine_ranks(two, "phase 8c (2 cards, NCCL)", card, ecfg)
    else:
        log("phase 8c: 1 card visible: the 2-card NCCL run is skipped for want of a second card")
    single = dp.spawn_local(dp_engine_rank, 1, "cuda", backend="nccl",
                            timeout=DP_RANKS_TIMEOUT_S,
                            args=(f"{work}/dp_nccl1", [(1, False)], [], ecfg))
    world1 = check_dp_engine_ranks(single, "phase 8c (world-1 NCCL group)", card, ecfg)
    seconds = time.perf_counter() - t0
    log(f"phase 8: {seconds:.1f} s ({card})")
    return {"dropout_base": dropout_base, "shared_card_gloo": shared,
            "small_steps_errors": worst, "small_steps_bound": DP_STEP_BOUND,
            "two_cards_nccl": two_cards, "world1_nccl": world1, "seconds": seconds,
            "launches": shared["launches_rank0"]}


# ------------------------------------------------------------------ phase 9
def config5_site_shapes() -> list[tuple[int, int, int, int]]:
    """The distinct (B, C, H, W) dropout-site shapes of the config-5 D."""
    shapes, h, w = [], C5_HEIGHT, C5_WIDTH
    for filters, _, (sh, sw) in DISC_TRUNK:
        h, w = -(-h // sh), -(-w // sw)
        if (C5_BATCH, filters, h, w) not in shapes:
            shapes.append((C5_BATCH, filters, h, w))
    return shapes


def check_dropout_spatial(dev: torch.device, card: str) -> dict:
    """Phase 9a: at every distinct config-5 D site shape, bf16 and f32,
    forward and backward, the kernel on an H-shard (image rows [s*H/2,
    (s+1)*H/2) of the whole batch, s = 0, 1; and batch rows [B/2, B) of
    image rows [H/2, H), data 2 x spatial 2) is bit-equal to the plain
    version with the same row-block mapping and to those elements of the
    whole array's kernel call. Timed at the largest site (bf16) on rows
    [H/2, H), L2 flushed and warm, beside the contiguous call of as many
    elements (batch rows [B/2, B) at full height, with their base)."""
    kw = KeyChain(7).dropout_kw(torch.zeros((), dtype=torch.int64, device=dev), 1)[0]
    cut = dropout.dropout_cut(0.5)
    n_checked = 0
    for shape in config5_site_shapes():
        b, c, h, w = shape
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(sum(shape) + 2)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = g.contiguous(memory_format=torch.channels_last)
            full_y = dropout.fwd_kernel(x, kw, cut)
            full_dx = dropout.bwd_kernel(x, g, kw, cut)
            hh = h // SP_SPATIAL
            for first, s in ((0, 0), (0, 1), (b // 2, 1)):
                rows, hrows = slice(first, b), slice(s * hh, (s + 1) * hh)
                xs = x[rows, :, hrows].contiguous(memory_format=torch.channels_last)
                gs = g[rows, :, hrows].contiguous(memory_format=torch.channels_last)
                base, hblock = dropout.rows_base(xs, first, h), (s * hh, h)
                at = f"{shape} {dtype} rows [{first}, {b}) image rows [{s * hh}, {(s + 1) * hh})"
                vector = (dropout.FWD_PATHS["vector"], dropout.BWD_PATHS["vector"])
                y = dropout.fwd_kernel(xs, kw, cut, base, x.numel(), hblock)
                dx = dropout.bwd_kernel(xs, gs, kw, cut, base, x.numel(), hblock)
                require((dropout.FWD_PATHS["vector"], dropout.BWD_PATHS["vector"])
                        == (vector[0] + 1, vector[1] + 1),
                        f"dropout on an H-shard {at}: not on the vector path")
                require(torch.equal(y, full_y[rows, :, hrows]),
                        f"dropout fwd on an H-shard {at}: differs from the whole array's")
                require(torch.equal(dx, full_dx[rows, :, hrows]),
                        f"dropout bwd on an H-shard {at}: differs from the whole array's")
                require(torch.equal(y, dropout.fwd_plain(xs, kw, cut, base, hblock)),
                        f"dropout fwd on an H-shard {at}: differs from plain")
                require(torch.equal(dx, dropout.bwd_plain(xs, gs, kw, cut, base, hblock)),
                        f"dropout bwd on an H-shard {at}: differs from plain")
                n_checked += 4
            del x, g, full_y, full_dx
    torch.cuda.empty_cache()
    shape = config5_site_shapes()[0]
    b, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    hh, total = h // SP_SPATIAL, x.numel()
    xs = x[:, :, hh:].contiguous(memory_format=torch.channels_last)
    gs = g[:, :, hh:].contiguous(memory_format=torch.channels_last)
    xr, gr = x[b // 2:], g[b // 2:]
    hblock, base_r = (hh, h), dropout.rows_base(x, b // 2)
    flush = L2Flush(dev)
    out = {}
    for name, shard, plain, contiguous, n_tensors in (
        ("leaky_relu_dropout_fwd", lambda: dropout.fwd_kernel(xs, kw, cut, 0, total, hblock),
         lambda: dropout.fwd_plain(xs, kw, cut, 0, hblock),
         lambda: dropout.fwd_kernel(xr, kw, cut, base_r, total), 2),
        ("leaky_relu_dropout_bwd", lambda: dropout.bwd_kernel(xs, gs, kw, cut, 0, total, hblock),
         lambda: dropout.bwd_plain(xs, gs, kw, cut, 0, hblock),
         lambda: dropout.bwd_kernel(xr, gr, kw, cut, base_r, total), 3),
    ):
        paths = dropout.FWD_PATHS if name.endswith("fwd") else dropout.BWD_PATHS
        vector = paths["vector"]
        shard()
        require(paths["vector"] == vector + 1,
                f"phase 9a: {name} on an H-shard did not take the vector path")
        times = timing(shard, plain, flush=flush)
        times["contiguous_ms"] = device_ms(contiguous, 20, flush=flush)
        times["contiguous_warm_ms"] = device_ms(contiguous, 20)
        out[name] = {"shape_nchw": list(xs.shape), "image_rows": [hh, h], **times,
                     **dropout_times.bound(n_tensors, xs.numel(), xs.element_size())}
        log(f"phase 9a: {name} on image rows [{hh}, {h}) of {shape} bf16: "
            f"{times['ms']:.4f} ms flushed, {times['warm_ms']:.4f} warm; contiguous "
            f"call of as many elements {times['contiguous_ms']:.4f} / "
            f"{times['contiguous_warm_ms']:.4f}; plain {times['plain_ms']:.4f} ms; bound "
            f"{out[name]['bound_ms']:.4f} ms ({card})")
    del flush
    log(f"phase 9a: dropout kernels on H-shards: {n_checked} shard calls at "
        f"{len(config5_site_shapes())} config-5 site shapes, bf16 and f32, bit-equal to the "
        "plain version with the same row-block mapping and to the whole array's call")
    return {"checked": n_checked, **out}


def spatial_engine_config() -> dict:
    """Config 5 (bench.py:360-411): 288x512, batch 16, base 512, SN, hinge,
    bf16, dropout 0.5, on SP_SPATIAL spatial ranks."""
    return dict(height=C5_HEIGHT, width=C5_WIDTH, batch=C5_BATCH, base=BASE,
                dtype=torch.bfloat16, epoch_batches=SP_EPOCH_BATCHES, spatial=SP_SPATIAL)


def plant_fault(fault: str | None) -> None:
    """A planted fault of the spatial layer, in this process: the gradients
    divided by the world instead of the data size; a summing backward on
    the spatial sum (the head's logits, the penalty's norms); no halo (each
    shard convolved as if its edges were the map's); a one-sided halo (the
    rows from below replaced by zeros, the rows from above exchanged)."""
    from imagegeneration_tpu_torch.nn import layers

    if fault == "world_divisor":
        mean = dp.all_reduce_mean_

        def world_mean(grads, group):
            out = mean(grads, group)
            torch._foreach_mul_([g for g in out if g is not None], group.data / group.world)
            return out

        dp.all_reduce_mean_ = world_mean
    elif fault == "summing_head":
        dp.spatial_sum = lambda x, group: dp.all_reduce_sum(x, group, "spatial")
    elif fault == "no_halo":
        layers.halo = lambda x, lo, hi, group: F.pad(x, (0, 0, lo, hi)).contiguous(
            memory_format=torch.channels_last)
    elif fault == "one_sided_halo":
        halo = layers.halo
        layers.halo = lambda x, lo, hi, group: F.pad(halo(x, lo, 0, group), (0, 0, 0, hi)
                                                     ).contiguous(memory_format=torch.channels_last)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    if fault is not None:  # unequal ranks still report
        dp.check_replicated = lambda state, group: dp.state_digest(state)


def spatial_rank(group, out: str, phases, small_jobs, ecfg: dict, fault: str | None,
                 replay: dict | None = None) -> dict:
    """One rank of phase 9b/9d: dp_engine_rank at config 5 on a data x
    spatial mesh, with this process's peak device memory; then, with
    `replay` (replayed_steps), each replayed step's distance from the one
    card's."""
    platform.configure_numerics()
    plant_fault(fault)
    torch.cuda.reset_peak_memory_stats(group.device)
    res = dp_engine_rank(group, out, phases, small_jobs, ecfg)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(group.device)
    if replay is not None:
        res["replay"] = replay_steps(group, ecfg, replay)
    return res


def spatial_step_config(ecfg: dict, dtype: torch.dtype, seed: int
                        ) -> steplib.SNDCGANTrainConfig:
    return steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(ecfg["height"], ecfg["width"], 3),
                            base_width=ecfg["base"], spectral_norm=True, dtype=dtype),
        batch_size=ecfg["batch"], loss="hinge", seed=seed)


def state_sums(state) -> torch.Tensor:
    """A fingerprint of a seeded state: for each floating tensor of
    `state.state_dict()`, the integer sum of its bit patterns (exact, in
    any order of summation), on its device."""
    sums = []
    for _, v in dp._leaves(state.state_dict()):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            bits = torch.int16 if v.element_size() == 2 else torch.int32
            sums.append(v.detach().contiguous().view(bits).long().sum())
    return torch.stack(sums)


def replayed_steps(work: str, ecfg: dict, dev: torch.device) -> dict:
    """The one-card side of phase 9b's replayed steps: for each of
    SP_REPLAYS, from the seeded state of its seed (its fingerprint kept:
    the ranks seed the same state), one SNDCGAN step on a synthetic batch of
    that seed, the state after it saved under `work` (the ranks load it).
    Also two floors (state_errors): the one card's bf16 step against its own
    float32 step from the same state (the rounding of bf16 alone), and its
    float32 step against the same step run again (cuDNN's run to run)."""
    out, rerun = {}, None
    for label, dtype, seed in SP_REPLAYS:
        cfg = spatial_step_config(ecfg, dtype, seed)
        batch = SyntheticImageDataset(ecfg["batch"], (ecfg["height"], ecfg["width"]),
                                      seed=9 + seed).images
        step = steplib.make_train_step(cfg)
        state = steplib.init_state(cfg, dev)
        sums0 = state_sums(state).cpu()
        state, _ = step(state, torch.from_numpy(batch).to(dev))
        path = f"{work}/replay_{label}.pt"
        torch.save(state.state_dict(), path)
        out[label] = {"dtype": dtype, "seed": seed, "sums0": sums0, "path": path,
                      "batch": batch}
        if label == "f32":
            again, _ = step(steplib.init_state(cfg, dev), torch.from_numpy(batch).to(dev))
            rerun = state_errors(again.state_dict(), state.state_dict())
            del again
        del state
        torch.cuda.empty_cache()
    floor = state_errors(torch.load(out["bf16"]["path"], map_location=dev),
                         torch.load(out["f32"]["path"], map_location=dev))
    torch.cuda.empty_cache()
    return {"steps": out, "bf16_vs_f32_one_card": floor, "f32_rerun_one_card": rerun}


def replay_steps(group, ecfg: dict, replay: dict) -> dict:
    """Each step of `replay` on this rank's rows and image rows, from the
    seeded state the one card started from, against the one card's state
    after it (state_errors), by SP_REPLAYS label."""
    dev = group.device
    rows = slice(*meshlib.process_row_range(group, ecfg["batch"]))
    image_rows = slice(*meshlib.spatial_row_range(group, ecfg["height"]))
    out = {}
    for label, r in replay["steps"].items():
        cfg = spatial_step_config(ecfg, r["dtype"], r["seed"])
        state = steplib.init_state(cfg, dev)
        require(torch.equal(state_sums(state).cpu(), r["sums0"]),
                f"replay {label}: rank {group.rank}'s seeded state is not the one card's")
        step = steplib.make_train_step(cfg, group)
        local = np.ascontiguousarray(r["batch"][rows, image_rows])
        state, _ = step(state, torch.from_numpy(local).to(dev))
        want = torch.load(r["path"], map_location=dev)
        out[label] = state_errors(state.state_dict(), want)
        del want, state
        torch.cuda.empty_cache()
    return out


def spatial_reference(out: str, phases, ecfg: dict, dev: torch.device) -> dict:
    """The one-card SNDCGANEngine run of phase 9b: the same configuration,
    data and phases, no group; its metrics per phase, its resumed epoch's
    perf.jsonl line and its peak memory above what the process held
    before."""
    dataset = SyntheticImageDataset(ecfg["epoch_batches"] * ecfg["batch"],
                                    (ecfg["height"], ecfg["width"]))
    kwargs = dict(image_size=(ecfg["height"], ecfg["width"], 3), device=dev,
                  spectral_norm=True, loss="hinge", dtype=ecfg["dtype"],
                  base_width=ecfg["base"], live_output=f"{out}/live")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = []
    for epochs, cont in phases:
        engine = SNDCGANEngine(f"{out}/sndcgan", dataset, ecfg["batch"], continue_=cont,
                               **kwargs)
        engine.train(epochs, 1)
        metrics.append(engine.last_epoch_metrics)
        del engine
    torch.cuda.synchronize()
    with open(f"{out}/sndcgan/perf.jsonl") as f:
        perf = json.loads(f.read().splitlines()[-1])
    return {"metrics": metrics, "perf": perf,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - held}


def state_errors(got: dict, want: dict) -> dict:
    """A state dict against another, per collection (a model's parameters
    and buffers, each optimizer moment): the worst collection's largest
    error over its largest |v| (as small_dp_errors), and where."""
    leaves_got = dict(dp._leaves(got))
    diff: dict[str, float] = {}
    scale: dict[str, float] = {}
    for path, b in dp._leaves(want):
        if not isinstance(b, torch.Tensor) or not b.is_floating_point():
            continue
        parts = path.strip("/").split("/")
        coll = "/".join(parts[:2] if parts[0].endswith("_opt") else parts[:1])
        a, b = leaves_got[path].double(), b.to(leaves_got[path].device).double()
        d = float((a - b).abs().max()) if bool(torch.isfinite(a).all()) else math.inf
        diff[coll] = max(diff.get(coll, 0.0), d)
        scale[coll] = max(scale.get(coll, 0.0), float(b.abs().max()))
    out = {"state": 0.0, "state_at": None}
    for coll, d in diff.items():
        rel = d / scale[coll] if scale[coll] else (math.inf if d else 0.0)
        if rel >= out["state"]:
            out["state"], out["state_at"] = rel, coll
    return out


def spatial_errors(ranks: list[dict], ref: dict) -> dict:
    """Phase 9b's distance of the spatial ranks from the one-card run: each
    epoch's engine metrics relative to max(1, |v|), and the state after
    each replayed step, from the one card's state before it, per
    collection (state_errors): "state" over the bf16 steps, "state_f32"
    over the float32 one; the worst over epochs, steps and ranks, with
    where."""
    out = {"metric": 0.0, "metric_at": None, "state": 0.0, "state_at": None,
           "state_f32": 0.0, "state_f32_at": None}
    for p, (ph, want) in enumerate(zip(ranks[0]["phases"], ref["metrics"])):
        for k, v in want.items():
            got = ph["metrics"][k]
            d = abs(got - v) / max(1.0, abs(v)) if math.isfinite(got) else math.inf
            if d >= out["metric"]:
                out["metric"], out["metric_at"] = d, f"epoch {p} {k}"
    for r in ranks:
        for label, errs in r.get("replay", {}).items():
            key = "state_f32" if label == "f32" else "state"
            if errs["state"] >= out[key]:
                out[key] = errs["state"]
                out[f"{key}_at"] = f"rank {r['rank']} {label} /{errs['state_at']}"
    return out


def within(err: dict, limits: dict) -> bool:
    return all(err[k] <= v for k, v in limits.items())


def small_spatial_jobs() -> list[tuple]:
    """Phase 9c: WGAN with the clip and with the penalty (32x32, base 16,
    batch 4, n_critic 2, float32, 4 steps), replayed step by step from the
    one-process states (filled in later)."""
    gen = np.random.default_rng(9)
    im = (32, 32, 3)
    wgan_in = {"batches": gen.integers(0, 256, (4, 4, *im), np.uint8),
               "z_fake": gen.normal(size=(4, 4, 128)).astype(np.float32),
               "z_gan": gen.normal(size=(4, 4, 128)).astype(np.float32)}
    jobs = []
    for name, gp in (("wgan_clip", 0.0), ("wgan_gp", 10.0)):
        cfg = wgan_step.WGANTrainConfig(model=WGANConfig(image_size=im, base_width=16),
                                        batch_size=4, n_critic=2, gp_lambda=gp)
        inputs = dict(wgan_in)
        if gp:
            inputs["gp_eps"] = gen.uniform(size=(4, 4, 1, 1, 1)).astype(np.float32)
        jobs.append((name, "wgan", cfg, inputs, None))
    return jobs


def run_spatial(card: str, work: str, dev: torch.device, fault: str | None = None) -> dict:
    """Phase 9: (a) the dropout kernels on H-shards; (b) config 5 on 2
    spatial ranks sharing this card over gloo through SNDCGANEngine, held to
    the one-card run within SP_BOUND, then (c) small WGAN steps on the same
    ranks held to one process on the card; (d) NCCL data 2 x spatial 2 on
    four cards where the machine has them. With `fault`, the ranks carry a
    planted fault and the phase requires their distance to exceed SP_BOUND
    (9a and 9d are skipped)."""
    t0 = time.perf_counter()
    ecfg = spatial_engine_config()
    torch.cuda.empty_cache()
    kernels = None if fault else check_dropout_spatial(dev, card)
    t_a = time.perf_counter()
    jobs = small_spatial_jobs()
    one = {}
    for i, (name, family, cfg, inputs, _) in enumerate(jobs):
        one[name] = dp_parity.run_steps(None, family, cfg, inputs, device=str(dev))
        replay = [one[name]["state0"]] + one[name]["states"][:-1]
        jobs[i] = (name, family, cfg, inputs, replay)
    phases = [(1, False), (2, True)]
    ref = spatial_reference(f"{work}/one", phases, ecfg, dev)
    replay = replayed_steps(work, ecfg, dev)
    torch.cuda.empty_cache()
    t_one = time.perf_counter()
    ranks = dp.spawn_local(spatial_rank, SP_SPATIAL, backend="gloo",
                           devices=[str(dev)] * SP_SPATIAL, timeout=SP_RANKS_TIMEOUT_S,
                           spatial=SP_SPATIAL,
                           args=(f"{work}/spatial", phases, jobs, ecfg, fault, replay))
    log(f"phase 9 times: 9a {t_a - t0:.1f} s, one-process runs {t_one - t_a:.1f} s, the "
        f"spatial ranks {time.perf_counter() - t_one:.1f} s")
    err = spatial_errors(ranks, ref)
    small = {name: small_dp_errors(ranks[0]["small"][name], want) for name, want in one.items()}
    label = f"phase 9b (config 5 on {SP_SPATIAL} spatial ranks sharing one card, gloo)"
    replays = {"ranks": [r["replay"] for r in ranks],
               "bf16_vs_f32_one_card": replay["bf16_vs_f32_one_card"],
               "f32_rerun_one_card": replay["f32_rerun_one_card"]}
    log(f"{label}: each replayed step against the one card's, per rank: {replays['ranks']}; "
        f"the one card's bf16 step against its own float32 step: "
        f"{replays['bf16_vs_f32_one_card']}; its float32 step against the same step run "
        f"again: {replays['f32_rerun_one_card']} ({card})")
    if fault is not None:
        shows = not within(err, SP_BOUND)
        log(f"{label}, planted fault {fault}: {err}; small WGAN {small}; exceeds the bound "
            f"{SP_BOUND}: {shows} ({card})")
        require(shows, f"planted fault {fault} stays within the bound {SP_BOUND}: {err}")
        return {"fault": fault, "errors": err, "replays": replays, "small_errors": small}
    shared = check_dp_engine_ranks(ranks, label, card, ecfg)
    for r in ranks:
        for p, ph in enumerate(r["phases"]):
            want_halo = SP_HALOS_PER_STEP * ph["steps"]
            require(ph["collectives"]["halo"] == want_halo and
                    ph["collectives"]["spatial_sum"] == 3 * ph["steps"],
                    f"{label} rank {r['rank']} phase {p}: {ph['collectives']}, expected "
                    f"{want_halo} halo exchanges and {3 * ph['steps']} spatial sums")
    require(within(err, SP_BOUND), f"{label}: {err} past the bound {SP_BOUND}")
    for name, e in small.items():
        got = [r["small"][name] for r in ranks]
        require(got[0]["digest"] == got[1]["digest"], f"phase 9c {name}: digests differ")
        for what, bound_rel in zip(("metric", "leaf"), DP_STEP_BOUND["wgan"]):
            require(e[what] <= bound_rel, f"phase 9c {name}: {what} error {e[what]} at "
                    f"{e[what + '_at']} past {bound_rel}")
    peaks = [r["peak_bytes"] for r in ranks]
    log(f"{label}: against the one-card run on the same batches: {err} (bound "
        f"{SP_BOUND}); per rank and step {SP_HALOS_PER_STEP} halo exchanges and 3 "
        f"spatial sums; peak device memory per rank {[p / 2**30 for p in peaks]} GiB, one "
        f"card {ref['peak_bytes'] / 2**30:.3f} GiB ({card})")
    log(f"phase 9c: small float32 WGAN steps (clip, penalty; 32x32 base 16 n_critic 2) on "
        f"{SP_SPATIAL} spatial ranks against one process on the card, each step from its "
        f"state: {small} (bounds (metric, leaf) {DP_STEP_BOUND['wgan']}); digests equal")
    four = run_four_cards(card, work, ecfg, phases, ref)
    seconds = time.perf_counter() - t0
    log(f"phase 9: {seconds:.1f} s ({card})")
    return {"dropout_shard": kernels, "shared_card_gloo": shared, "errors": err,
            "replays": replays, "bound": SP_BOUND, "small_errors": small, "peak_bytes_per_rank": peaks,
            "peak_bytes_one_card": ref["peak_bytes"], "four_cards_nccl": four,
            "seconds": seconds, "launches": shared["launches_rank0"]}


def run_four_cards(card: str, work: str, ecfg: dict, phases, ref: dict) -> dict | None:
    """Phase 9d: config 5 over NCCL on four cards as data 2 x spatial 2
    (each rank 8 rows and 144 image rows), through SNDCGANEngine, its
    epoch metrics against the one-card run's (`ref`) within SP_BOUND;
    steps/s and global images/s of the resumed epoch beside the one card's.
    None, with a line, on fewer cards."""
    if torch.cuda.device_count() < 4:
        log(f"phase 9d: {torch.cuda.device_count()} card(s) visible: the 4-card NCCL data 2 x "
            "spatial 2 run is skipped for want of cards")
        return None
    label = "phase 9d (NCCL data 2 x spatial 2, 4 cards)"
    ranks = dp.spawn_local(spatial_rank, 4, "cuda", backend="nccl", spatial=SP_SPATIAL,
                           timeout=SP_RANKS_TIMEOUT_S,
                           args=(f"{work}/spatial4", phases, [], ecfg, None))
    four = check_dp_engine_ranks(ranks, label, card, ecfg)
    err = spatial_errors(ranks, ref)
    require(err["metric"] <= SP_BOUND["metric"], f"{label}: metrics {err} past {SP_BOUND}")
    one = ref["perf"]
    log(f"{label}: epoch metrics against the one-card run {err['metric']} at "
        f"{err['metric_at']}; peak device memory per rank "
        f"{[r['peak_bytes'] / 2**30 for r in ranks]} GiB; resumed epoch "
        f"{four['last_epoch_steps_per_sec']:.3f} steps/s, "
        f"{four['last_epoch_images_per_sec']:.1f} global images/s; one card "
        f"{one['steps_per_sec']:.3f} steps/s, {one['images_per_sec']:.1f} images/s ({card})")
    return {**four, "metric_error": err["metric"], "one_card": one,
            "peak_bytes": [r["peak_bytes"] for r in ranks]}


# ----------------------------------------------------------------- phase 9e
def cyclegan_spatial_config() -> dict:
    """The headline CycleGAN (bench.py:489-503: 128x128, batch 4, base 64, 9
    res blocks, float32) on CG_SP_SPATIAL spatial ranks, CG_SP_EPOCH_BATCHES
    batches an epoch."""
    return dict(size=CG_SIZE, batch=CG_BATCH, base=CG_BASE, res=CG_RES,
                dtype=torch.float32, epoch_batches=CG_SP_EPOCH_BATCHES,
                spatial=CG_SP_SPATIAL)


def cyclegan_spatial_per_step(n_res: int) -> tuple[dict, dict]:
    """(hand-kernel launches, collectives) per rank and step of the CycleGAN
    step under a spatial partition. A generator pass has P = 6 + 2 * n_res
    norms (the split kernels) and P halo exchanges (the 7x7 stem and to_rgb,
    the two reflect pads, the res blocks' convs, the two ConvTransposes); a
    PatchGAN pass 3 whole-map norms and 1 row gather. The forward runs 6
    generator and 4 PatchGAN passes; pulls 1 and 2 each run 1 PatchGAN and
    4 generator passes back, 3 of which need no gradient of their input (a
    batch, or a translation only the other generator's parameters reach),
    so their stem exchanges no adjoint; pull 3 runs the 4 PatchGAN passes
    back; 4 L1 sums over the spatial peers; 4 Adam applies, each after one
    gradient all-reduce."""
    p = 6 + 2 * n_res
    launches = {**no_launches(), "instance_norm_fwd_partial": 6 * p,
                "instance_norm_fwd_apply": 6 * p, "instance_norm_bwd_partial": 8 * p,
                "instance_norm_bwd_apply": 8 * p, "instance_norm_fwd": 4 * 3,
                "instance_norm_bwd": 2 * 3 + 4 * 3, "adam": 4}
    collectives = {"halo": 14 * p - 6, "norm_gather": 6 * p, "norm_all_reduce": 8 * p,
                   "row_gather": 4, "spatial_sum": 4, "grad_all_reduce": 4}
    return launches, collectives


def plant_cyclegan_fault(fault: str | None) -> None:
    """A planted fault of the CycleGAN spatial path, in this process: each
    shard's norms take its own rows' statistics; the PatchGANs' gradients
    summed over every spatial peer (not counted once); the inner shard
    edges reflected instead of exchanged."""
    from imagegeneration_tpu_torch.nn import layers

    if fault == "local_in_stats":
        layers.instance_norm = lambda x, g, b, eps=1e-3, relu=False, group=None: \
            inorm.instance_norm(x, g, b, eps, relu)
    elif fault == "d_grad_every_peer":
        cyclegan_step.count_once = lambda grads, group: list(grads)
    elif fault == "inner_reflect":
        layers.reflect_halo = lambda x, n, group: F.pad(x, (0, 0, n, n), mode="reflect")
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    if fault is not None:  # unequal ranks still report
        dp.check_replicated = lambda state, group: dp.state_digest(state)


def cyclegan_spatial_datasets(ecfg: dict) -> list[SyntheticImageDataset]:
    return [SyntheticImageDataset(ecfg["epoch_batches"] * ecfg["batch"],
                                  (ecfg["size"], ecfg["size"]), seed=s) for s in (1, 2)]


def cyclegan_engine_kwargs(ecfg: dict, dev: torch.device, group=None) -> dict:
    return dict(device=dev, base_width=ecfg["base"], n_res_blocks=ecfg["res"],
                dtype=ecfg["dtype"], mesh=group)


def cyclegan_step_config(ecfg: dict, seed: int) -> cyclegan_step.CycleGANTrainConfig:
    return cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=(ecfg["size"], ecfg["size"], 3),
                             base_width=ecfg["base"], n_res_blocks=ecfg["res"],
                             dtype=ecfg["dtype"]),
        batch_size=ecfg["batch"], seed=seed)


def cyclegan_replay_batches(ecfg: dict) -> list[np.ndarray]:
    return [SyntheticImageDataset(ecfg["batch"], (ecfg["size"], ecfg["size"]), seed=s).images
            for s in (11, 12)]


def cyclegan_replayed_step(work: str, ecfg: dict, dev: torch.device) -> dict:
    """The one-card side of phase 9e's replayed step: from the seeded state
    (its fingerprint kept: the ranks seed the same state), one float32 step
    on a synthetic batch pair, the state after it saved under `work`; and the
    same step run again (the floor of cuDNN's run to run)."""
    cfg = cyclegan_step_config(ecfg, 0)
    bx, by = (torch.from_numpy(b).to(dev) for b in cyclegan_replay_batches(ecfg))
    step = cyclegan_step.make_train_step(cfg)
    state = cyclegan_step.init_state(cfg, dev)
    sums0 = state_sums(state).cpu()
    state, _ = step(state, bx, by)
    path = f"{work}/cyclegan_replay.pt"
    torch.save(state.state_dict(), path)
    again, _ = step(cyclegan_step.init_state(cfg, dev), bx, by)
    rerun = state_errors(again.state_dict(), state.state_dict())
    del state, again
    torch.cuda.empty_cache()
    return {"sums0": sums0, "path": path, "f32_rerun_one_card": rerun}


def cyclegan_spatial_rank(group, out: str, phases, ecfg: dict, fault: str | None,
                          replay: dict) -> dict:
    """One rank of phase 9e/9f: CycleGANEngine at `ecfg` on a data x spatial
    mesh for `phases` (epochs per engine; each later engine auto-resumes),
    with the launch and collective counts, the digest, the artifacts this
    rank wrote and its peak device memory; then the replayed step's distance
    from the one card's."""
    platform.configure_numerics()
    plant_cyclegan_fault(fault)
    torch.cuda.reset_peak_memory_stats(group.device)
    writes = count_writes()
    datasets = cyclegan_spatial_datasets(ecfg)
    size = (ecfg["size"], ecfg["size"])
    results = []
    for epochs in phases:
        engine = CycleGANEngine(*datasets, f"{out}/cyclegan", ecfg["batch"], size,
                                **cyclegan_engine_kwargs(ecfg, group.device, group))
        start = engine.epoch
        zero_launches()
        before = dict(group.counts)
        torch.cuda.synchronize(group.device)
        t0 = time.perf_counter()
        engine.train(epochs, 1)
        torch.cuda.synchronize(group.device)
        seconds = time.perf_counter() - t0
        perf = None
        if group.is_main:
            with open(f"{out}/cyclegan/perf.jsonl") as f:
                perf = json.loads(f.read().splitlines()[-1])
        results.append({
            "start": start, "steps": engine.num_batches * epochs, "seconds": seconds,
            "perf": perf, "launches": read_launches(), "grad_copies": adam.GRAD_COPIES["adam"],
            "collectives": {k: group.counts[k] - before[k] for k in before},
            "digest": engine.last_digest, "metrics": engine.last_epoch_metrics,
            "resident": engine.resident})
        del engine
    peak = torch.cuda.max_memory_allocated(group.device)
    cfg = cyclegan_step_config(ecfg, 0)
    state = cyclegan_step.init_state(cfg, group.device)
    require(torch.equal(state_sums(state).cpu(), replay["sums0"]),
            f"rank {group.rank}'s seeded CycleGAN state is not the one card's")
    rows = slice(*meshlib.process_row_range(group, ecfg["batch"]))
    image_rows = slice(*meshlib.spatial_row_range(group, ecfg["size"]))
    bx, by = (torch.from_numpy(np.ascontiguousarray(b[rows, image_rows])).to(group.device)
              for b in cyclegan_replay_batches(ecfg))
    state, _ = cyclegan_step.make_train_step(cfg, group)(state, bx, by)
    replayed = state_errors(state.state_dict(),
                            torch.load(replay["path"], map_location=group.device))
    return {"rank": group.rank, "backend": group.backend, "device": str(group.device),
            "phases": results, "writes": writes, "peak_bytes": peak, "replay": replayed}


def cyclegan_spatial_reference(out: str, phases, ecfg: dict, dev: torch.device) -> dict:
    """The one-card CycleGANEngine run of phase 9e: the same configuration,
    data and phases, no group; its epoch metrics, its resumed epoch's
    perf.jsonl line and its peak memory above what the process held."""
    datasets = cyclegan_spatial_datasets(ecfg)
    size = (ecfg["size"], ecfg["size"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = []
    for epochs in phases:
        engine = CycleGANEngine(*datasets, f"{out}/cyclegan", ecfg["batch"], size,
                                **cyclegan_engine_kwargs(ecfg, dev))
        engine.train(epochs, 1)
        metrics.append(engine.last_epoch_metrics)
        del engine
    torch.cuda.synchronize()
    with open(f"{out}/cyclegan/perf.jsonl") as f:
        perf = json.loads(f.read().splitlines()[-1])
    return {"metrics": metrics, "perf": perf,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - held}


def cyclegan_spatial_errors(ranks: list[dict], ref: dict) -> dict:
    """Phase 9e's distance of the spatial ranks from the one-card run: each
    epoch's metrics relative to max(1, |v|), and the replayed step's state
    per collection (state_errors); the worst over epochs and ranks, with
    where."""
    out = {"metric": 0.0, "metric_at": None, "state": 0.0, "state_at": None}
    for p, (ph, want) in enumerate(zip(ranks[0]["phases"], ref["metrics"])):
        for k, v in want.items():
            got = ph["metrics"][k]
            d = abs(got - v) / max(1.0, abs(v)) if math.isfinite(got) else math.inf
            if d >= out["metric"]:
                out["metric"], out["metric_at"] = d, f"epoch {p} {k}"
    for r in ranks:
        if r["replay"]["state"] >= out["state"]:
            out["state"] = r["replay"]["state"]
            out["state_at"] = f"rank {r['rank']} /{r['replay']['state_at']}"
    return out


def check_cyclegan_spatial_ranks(ranks: list[dict], label: str, card: str, ecfg: dict) -> dict:
    """Per rank: exact launches and collectives per step
    (cyclegan_spatial_per_step), no Adam gradient copy, bit-equal digests
    after each phase, artifacts from rank 0 only."""
    per_launch, per_coll = cyclegan_spatial_per_step(ecfg["res"])
    for p in range(len(ranks[0]["phases"])):
        require(len({r["phases"][p]["digest"] for r in ranks}) == 1,
                f"{label} phase {p}: rank digests differ")
        for r in ranks:
            ph = r["phases"][p]
            steps = ph["steps"]
            want = {k: v * steps for k, v in per_launch.items()}
            require(ph["launches"] == want, f"{label} rank {r['rank']} phase {p}: launches "
                    f"{ph['launches']}, expected {want}")
            got = {k: ph["collectives"][k] for k in per_coll}
            want = {k: v * steps for k, v in per_coll.items()}
            require(got == want, f"{label} rank {r['rank']} phase {p}: collectives {got}, "
                    f"expected {want}")
            require(ph["grad_copies"] == 0, f"{label}: adam gradient copies {ph['grad_copies']}")
            require(ph["start"] == p and all(math.isfinite(v) for v in ph["metrics"].values()),
                    f"{label} rank {r['rank']} phase {p}: start {ph['start']}, {ph['metrics']}")
    require(all(v > 0 for v in ranks[0]["writes"].values()),
            f"{label}: rank 0 wrote {ranks[0]['writes']}")
    for r in ranks[1:]:
        require(set(r["writes"].values()) == {0}, f"{label}: rank {r['rank']} wrote {r['writes']}")
    perf = ranks[0]["phases"][-1]["perf"]
    log(f"{label}: backend {ranks[0]['backend']}, {len(ranks)} ranks on "
        f"{sorted({r['device'] for r in ranks})}, {ecfg['size']}x{ecfg['size']} global batch "
        f"{ecfg['batch']} base {ecfg['base']} {ecfg['res']} res blocks {ecfg['dtype']}; per rank "
        f"and step: launches {per_launch}, collectives {per_coll}, 0 gradient copies; digests "
        f"equal after each epoch; artifacts from rank 0 only {ranks[0]['writes']}; resumed "
        f"epoch {perf['steps_per_sec']:.3f} steps/s, {perf['images_per_sec']:.2f} global "
        f"images/s ({card})")
    return {"ranks": len(ranks), "backend": ranks[0]["backend"],
            "devices": sorted({r["device"] for r in ranks}),
            "last_epoch_steps_per_sec": perf["steps_per_sec"],
            "last_epoch_images_per_sec": perf["images_per_sec"],
            "launches_rank0": {k: sum(ph["launches"][k] for ph in ranks[0]["phases"])
                               for k in ranks[0]["phases"][0]["launches"]},
            "collectives_per_step": per_coll, "peak_bytes": [r["peak_bytes"] for r in ranks]}


def run_cyclegan_spatial(card: str, work: str, dev: torch.device,
                         fault: str | None = None) -> dict:
    """Phase 9e: the headline CycleGAN on CG_SP_SPATIAL spatial ranks sharing
    this card over gloo, through CycleGANEngine for a 4-step epoch and an
    auto-resumed one, held to the one-card engine on the same batches, then
    a float32 step replayed from the one card's seeded state, both within
    CG_SP_BOUND; then (9f) NCCL data 2 x spatial 2 on four cards where the
    machine has them. With `fault`, the ranks carry a planted fault and the
    phase requires their distance to exceed CG_SP_BOUND (9f is skipped)."""
    t0 = time.perf_counter()
    ecfg = cyclegan_spatial_config()
    phases = [1, 1]
    torch.cuda.empty_cache()
    ref = cyclegan_spatial_reference(f"{work}/cg_one", phases, ecfg, dev)
    replay = cyclegan_replayed_step(work, ecfg, dev)
    torch.cuda.empty_cache()
    t_one = time.perf_counter()
    ranks = dp.spawn_local(cyclegan_spatial_rank, ecfg["spatial"], backend="gloo",
                           devices=[str(dev)] * ecfg["spatial"], timeout=SP_RANKS_TIMEOUT_S,
                           spatial=ecfg["spatial"],
                           args=(f"{work}/cg_spatial", phases, ecfg, fault, replay))
    err = cyclegan_spatial_errors(ranks, ref)
    label = (f"phase 9e (CycleGAN {ecfg['size']}x{ecfg['size']} on {ecfg['spatial']} spatial "
             "ranks sharing one card, gloo)")
    log(f"phase 9e times: the one-card runs {t_one - t0:.1f} s, the spatial ranks "
        f"{time.perf_counter() - t_one:.1f} s; the one card's float32 step against the same "
        f"step run again: {replay['f32_rerun_one_card']} ({card})")
    if fault is not None:
        shows = not within(err, CG_SP_BOUND)
        log(f"{label}, planted fault {fault}: {err}; exceeds the bound {CG_SP_BOUND}: {shows} "
            f"({card})")
        require(shows, f"planted fault {fault} stays within the bound {CG_SP_BOUND}: {err}")
        return {"fault": fault, "errors": err}
    shared = check_cyclegan_spatial_ranks(ranks, label, card, ecfg)
    log(f"{label}: against the one-card run on the same batches: {err} (bound {CG_SP_BOUND}); "
        f"peak device memory per rank {[r['peak_bytes'] / 2**30 for r in ranks]} GiB, one card "
        f"{ref['peak_bytes'] / 2**30:.3f} GiB; one card's resumed epoch "
        f"{ref['perf']['steps_per_sec']:.3f} steps/s ({card})")
    require(within(err, CG_SP_BOUND), f"{label}: {err} past the bound {CG_SP_BOUND}")
    four = run_cyclegan_four_cards(card, work, ecfg, phases, ref, replay)
    seconds = time.perf_counter() - t0
    log(f"phase 9e/9f: {seconds:.1f} s ({card})")
    return {"shared_card_gloo": shared, "errors": err, "bound": CG_SP_BOUND,
            "f32_rerun_one_card": replay["f32_rerun_one_card"],
            "peak_bytes_one_card": ref["peak_bytes"], "one_card_perf": ref["perf"],
            "four_cards_nccl": four, "seconds": seconds, "launches": shared["launches_rank0"]}


def run_cyclegan_four_cards(card: str, work: str, ecfg: dict, phases, ref: dict,
                            replay: dict) -> dict | None:
    """Phase 9f: the headline CycleGAN over NCCL on four cards as data 2 x
    spatial 2 (each rank 2 rows and 64 image rows), through CycleGANEngine,
    held as 9e to the one-card run (`ref`, `replay`) within CG_SP_BOUND;
    steps/s and global images/s of the resumed epoch beside the one card's.
    None, with a line, on fewer cards."""
    if torch.cuda.device_count() < 4:
        log(f"phase 9f: {torch.cuda.device_count()} card(s) visible: the 4-card NCCL data 2 x "
            "spatial 2 CycleGAN run is skipped for want of cards")
        return None
    label = "phase 9f (CycleGAN, NCCL data 2 x spatial 2, 4 cards)"
    ranks = dp.spawn_local(cyclegan_spatial_rank, 4, "cuda", backend="nccl",
                           spatial=ecfg["spatial"], timeout=SP_RANKS_TIMEOUT_S,
                           args=(f"{work}/cg_spatial4", phases, ecfg, None, replay))
    four = check_cyclegan_spatial_ranks(ranks, label, card, ecfg)
    err = cyclegan_spatial_errors(ranks, ref)
    require(within(err, CG_SP_BOUND), f"{label}: {err} past the bound {CG_SP_BOUND}")
    log(f"{label}: against the one-card run {err}; peak device memory per rank "
        f"{[r['peak_bytes'] / 2**30 for r in ranks]} GiB; one card "
        f"{ref['perf']['steps_per_sec']:.3f} steps/s, {ref['perf']['images_per_sec']:.2f} "
        f"images/s ({card})")
    return {**four, "errors": err, "one_card": ref["perf"]}


# ----------------------------------------------------------------- phase 10
def keras_kernel(rng, shape: tuple, fan_in: int) -> np.ndarray:
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(fan_in**-0.5)


def keras_sndcgan_generator_layers(rng) -> list:
    """The reference SNDCGAN generator's Keras layers (SNDCGAN.py:25-66) at
    256x144, base 512, as `keras_import.read_h5_layers` returns them from a
    reference .h5: [(layer, {weight: array})] in model order, an empty dict
    for a layer without weights. Kernels N(0, 1/fan_in), BatchNorm
    statistics away from their init. A 4x4 stride-2 ConvTranspose sums 2x2
    taps of each input channel into an output, so its fan-in is 4 x in."""
    def bn(c: int) -> dict:
        return {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "beta": rng.normal(0, 0.1, c).astype(np.float32),
                "moving_mean": rng.normal(0, 0.1, c).astype(np.float32),
                "moving_variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    stem = BASE * (HEIGHT // 8) * (WIDTH // 8)
    layers = [("dense", {"kernel": keras_kernel(rng, (128, stem), 128)}),
              ("batch_normalization", bn(stem)), ("re_lu", {}), ("reshape", {})]
    feats = BASE
    for i, out in enumerate((BASE // 2, BASE // 4, BASE // 8)):
        layers += [(f"conv2d_transpose_{i}",
                    {"kernel": keras_kernel(rng, (4, 4, out, feats), 4 * feats)}),
                   (f"batch_normalization_{i + 1}", bn(out)), (f"re_lu_{i + 1}", {})]
        feats = out
    return layers + [("conv2d_transpose_3",
                      {"kernel": keras_kernel(rng, (3, 3, 3, feats), 9 * feats)})]


def keras_cyclegan_generator_stream(rng, per_h: bool) -> list:
    """The reference CycleGAN generator's save_weights stream
    (CycleGAN.py:161-183) at 128x128, base 64, 9 res blocks, as
    `keras_import._read_save_weights_h5` returns it: [(weight path, array)],
    per layer conv kernel (Conv2DTranspose: (k, k, out, in)), conv bias, IN
    gamma, IN beta; with `per_h`, tfa InstanceNormalization(axis=1)
    artifacts, one gamma/beta per row of the norm's input."""
    h, b = CG_SIZE, CG_BASE
    specs = ([(7, 3, b, h, False), (3, b, 2 * b, h // 2, False),
              (3, 2 * b, 4 * b, h // 4, False)]
             + [(3, 4 * b, 4 * b, h // 4, False)] * (2 * CG_RES)
             + [(3, 4 * b, 2 * b, h // 2, True), (3, 2 * b, b, h, True), (7, b, 3, h, False)])
    stream = []
    for i, (k, cin, cout, rows, transpose) in enumerate(specs):
        n = rows if per_h else cout
        shape = (k, k, cout, cin) if transpose else (k, k, cin, cout)
        stream += [(f"layer_{i}/kernel:0", keras_kernel(rng, shape, k * k * cin)),
                   (f"layer_{i}/bias:0", rng.normal(0, 0.1, cout).astype(np.float32)),
                   (f"layer_{i}/gamma:0", rng.uniform(0.5, 1.5, n).astype(np.float32)),
                   (f"layer_{i}/beta:0", rng.normal(0, 0.1, n).astype(np.float32))]
    return stream


def flat_leaves(tree, at: str = "") -> dict:
    if not isinstance(tree, dict):
        return {at: tree}
    return {p: a for k, v in tree.items() for p, a in flat_leaves(v, f"{at}/{k}").items()}


def check_bit_equal(what: str, got: dict, want: dict) -> int:
    """Every leaf of `want` in `got` with its shape, dtype and bytes; the
    number of leaves."""
    got, want = flat_leaves(got), flat_leaves(want)
    require(sorted(got) == sorted(want), f"{what}: leaves {sorted(set(got) ^ set(want))}")
    for path, a in want.items():
        b = got[path]
        require(b.shape == a.shape and b.dtype == a.dtype and b.tobytes() == a.tobytes(),
                f"{what}: {path} differs")
    return len(want)


def migrate(tree: dict, export: str, model: torch.nn.Module, what: str) -> dict:
    """Export a mapped tree, read it back and bridge it into `model` on the
    card; the export and the card's weights bit-equal to the tree."""
    ckptlib.export_params(export, tree)
    loaded = load_params(export)
    n = check_bit_equal(f"{what}: the export read back", loaded, tree)
    bridge.load_flax_variables(model, loaded)
    on_card = bridge.flax_variables(model)
    check_bit_equal(f"{what}: the weights on the card", on_card,
                    {c: t for c, t in tree.items() if t})
    return {"leaves": n, "export_bytes": os.path.getsize(export)}


def run_migration(card: str, work: str, dev: torch.device) -> dict:
    """Phase 10: the reference-weights migration at the reference shapes,
    without h5py. The Keras layer lists of a reference SNDCGAN generator
    (256x144, base 512: its Dense kernel is 128 x 294,912) and of a CycleGAN
    generator (128x128, base 64, 9 res blocks; per-channel and per-H norms)
    go through the port's mapping functions, `export_params`, `load_params`
    and the bridge onto the card (weights bit-equal to the tree); the
    SNDCGAN export is sampled by the sampling CLI on the card and on the
    CPU, the CycleGAN exports translate one batch on the card and on the
    CPU, each within MIGRATION_BOUND; the launch counters zeroed before and
    read after (24 InstanceNorm forwards: the per-channel translation on
    the card; the per-H norm is plain torch)."""
    from imagegeneration_tpu_torch.compat import keras_import

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.perf_counter()
    rng = np.random.default_rng(10)
    run = f"{work}/migration"
    image = (HEIGHT, WIDTH, 3)
    tree = keras_import.sndcgan_generator_tree(keras_sndcgan_generator_layers(rng))
    base = bridge.sndcgan_base_width(tree)
    require(base == BASE, f"imported base width {base}")
    gen = Generator(SNDCGANConfig(image_size=image, base_width=base), torch.Generator()).to(dev)
    out = {"sndcgan": migrate(tree, f"{run}/models/generator/gen_model-0.msgpack", gen,
                              "sndcgan-gen")}
    del gen
    t_map = time.perf_counter()
    args = (MIGRATION_BATCH, run, 1, "grid", 0, image, 128, 62)
    epochs, on_card = generator_output.output_results_models(*args, device=dev,
                                                             return_samples=True)
    t_card = time.perf_counter()
    _, on_cpu = generator_output.output_results_models(*args, device="cpu",
                                                       return_samples=True)
    t_cpu = time.perf_counter()
    a, b = on_card[0], on_cpu[0]
    err = float(np.abs(a - b).max())
    require(epochs == [0] and a.shape == (MIGRATION_BATCH, *image) and bool(np.isfinite(a).all())
            and 0.0 <= a.min() and a.max() <= 1.0, f"samples of the imported generator: "
            f"epochs {epochs}, shape {a.shape}, range [{a.min()}, {a.max()}]")
    require(err <= MIGRATION_BOUND, f"sndcgan-gen: card samples {err:.3g} from the CPU's "
            f"(bound {MIGRATION_BOUND})")
    out["sndcgan"].update({"max_abs_err": err, "range": [float(a.min()), float(a.max())],
                           "std": float(a.std()), "card_s": t_card - t_map,
                           "cpu_s": t_cpu - t_card})
    log(f"phase 10 sndcgan-gen {HEIGHT}x{WIDTH} base {base}: {out['sndcgan']['leaves']} leaves, "
        f"export {out['sndcgan']['export_bytes']} bytes, bit-equal read back and on the card; "
        f"sampling CLI, {MIGRATION_BATCH} samples, card vs CPU max abs {err:.3g} (bound "
        f"{MIGRATION_BOUND}), samples in [{a.min():.4f}, {a.max():.4f}] std {a.std():.4f}; "
        f"map+export+load+bridge {t_map - t0:.2f} s, card {t_card - t_map:.2f} s, CPU "
        f"{t_cpu - t_card:.2f} s")
    x = torch.from_numpy(rng.uniform(-1, 1, (MIGRATION_BATCH, 3, CG_SIZE, CG_SIZE)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    for per_h in (False, True):
        label = "per_h" if per_h else "per_channel"
        t1 = time.perf_counter()
        tree = keras_import.cyclegan_generator_tree(keras_cyclegan_generator_stream(rng, per_h))
        cfg = CycleGANConfig(image_size=(CG_SIZE, CG_SIZE, 3), base_width=CG_BASE,
                             n_res_blocks=CG_RES, quirk_axis1=per_h)
        export = f"{run}/models/generator_g/gen_weights_g-{int(per_h)}.msgpack"
        gen = CycleGANGenerator(cfg, torch.Generator()).to(dev).eval()
        rec = migrate(tree, export, gen, f"cyclegan-gen {label}")
        cpu_gen = CycleGANGenerator(cfg, torch.Generator()).eval()
        bridge.load_flax_variables(cpu_gen, load_params(export))
        with torch.no_grad():
            y = gen(x.to(dev)).cpu()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            want = cpu_gen(x)
        err = float((y - want).abs().max())
        require(y.shape == x.shape and bool(torch.isfinite(y).all()),
                f"cyclegan-gen {label}: translation {tuple(y.shape)}")
        require(err <= MIGRATION_BOUND, f"cyclegan-gen {label}: card translation {err:.3g} "
                f"from the CPU's (bound {MIGRATION_BOUND})")
        rec.update({"max_abs_err": err, "std": float(y.std()), "card_s": t2 - t1,
                    "cpu_s": time.perf_counter() - t2})
        out[f"cyclegan_{label}"] = rec
        log(f"phase 10 cyclegan-gen {label} {CG_SIZE}x{CG_SIZE} base {CG_BASE} {CG_RES} res "
            f"blocks: {rec['leaves']} leaves, bit-equal read back and on the card; one batch "
            f"of {MIGRATION_BATCH} card vs CPU max abs {err:.3g} (bound {MIGRATION_BOUND}), "
            f"std {rec['std']:.4f}; map+export+load+bridge+card {t2 - t1:.2f} s, CPU "
            f"{rec['cpu_s']:.2f} s")
        del gen
    launches = read_launches()
    want = no_launches()
    want["instance_norm_fwd"] = IN_PER_TRANSLATION
    require(launches == want, f"phase 10: launches {launches}, expected {want}")
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    log(f"phase 10 (reference-weights migration): {seconds:.1f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB over the {held / 2**30:.3f} GiB held before it; launches "
        f"{launches} ({card})")
    return {**out, "launches": launches, "seconds": seconds, "peak_bytes": peak,
            "bound": MIGRATION_BOUND}


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    parser.add_argument("--only-phase", choices=["9", "9d", "9e", "9f", "10"], default=None,
                        help="build the kernels and run phase 9a-9d (SNDCGAN and WGAN "
                        "spatial) alone, its 4-card part 9d, phase 9e (CycleGAN spatial), "
                        "or its 4-card part 9f, each with the one-card run it is held to, "
                        "or phase 10 (the reference-weights migration)")
    parser.add_argument("--plant", choices=SP_FAULTS + CG_FAULTS, default=None,
                        help="phase 9b/9c (SP_FAULTS) or 9e (CG_FAULTS) with this fault "
                        "planted in the spatial ranks; passes when it moves them past "
                        "SP_BOUND or CG_SP_BOUND")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = platform.require_cuda()
    numerics = platform.configure_numerics()
    card = platform.card_description()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {numerics}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    native.build_all(list(KERNELS))
    for name in KERNELS:
        native.load(name)
        info = native.BUILD_LOG[name]
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        log(f"built {name}.cu in {info['seconds']:.2f} s: {regs}")
    log(f"kernel build total {time.perf_counter() - t0:.2f} s (parallel)")
    if args.only_phase is not None or args.plant is not None:
        with tempfile.TemporaryDirectory() as work:
            if args.only_phase in ("9d", "9f"):
                require(torch.cuda.device_count() >= 4, f"--only-phase {args.only_phase} "
                        "needs 4 cards")
            if args.only_phase == "9d":
                ecfg, phases = spatial_engine_config(), [(1, False), (2, True)]
                spatial = run_four_cards(card, work, ecfg, phases,
                                         spatial_reference(f"{work}/one", phases, ecfg, dev))
            elif args.only_phase == "9f":
                ecfg, phases = cyclegan_spatial_config(), [1, 1]
                spatial = run_cyclegan_four_cards(
                    card, work, ecfg, phases,
                    cyclegan_spatial_reference(f"{work}/cg_one", phases, ecfg, dev),
                    cyclegan_replayed_step(work, ecfg, dev))
            elif args.only_phase == "9e" or args.plant in CG_FAULTS:
                spatial = run_cyclegan_spatial(card, work, dev, args.plant)
            elif args.only_phase == "10":
                print(json.dumps({"migration": run_migration(card, work, dev), "card": card}))
                return 0
            else:
                spatial = run_spatial(card, work, dev, args.plant)
        print(json.dumps({"spatial": spatial, "card": card}))
        return 0
    kernels = check_dropout(dev, card)
    kernels.append(check_adam(dev, card))
    kernels.append(check_adam_bf16(dev, card))
    kernels += check_instance_norm(card)
    kernels += check_split_instance_norm(card)
    check_small_step_against_cpu(dev)
    check_small_cyclegan_step_against_cpu(dev)
    check_small_wgan_steps_against_cpu(dev)
    check_small_wgan_bf16_steps(dev)
    cg_bf16 = check_small_cyclegan_bf16_steps(dev)
    with tempfile.TemporaryDirectory() as work:
        slices = {"sndcgan": run_sndcgan_slice(card, work),
                  "cyclegan": run_cyclegan_slice(card, work), "wgan": run_wgan_slice(card)}
        run_twice = check_run_twice(card)
        options = run_sndcgan_options(card)
        profile = check_profile_trace(card, work)
        offline = run_sampling_and_fid(card, work, dev)
        evaluation = run_evaluation(card, work, dev, kernels)
        data_parallel = run_data_parallel(card, work, dev)
        spatial = run_spatial(card, work, dev)
        cg_spatial = run_cyclegan_spatial(card, work, dev)
        migration = run_migration(card, work, dev)
    names = {k["name"] for k in kernels}
    for p, r in slices.items():
        require(set(r["launches"]) == names, f"{p}: counters {sorted(r['launches'])} "
                f"are not the kernels {sorted(names)}")
    require(set(evaluation["launches"]) == names,
            f"evaluation: counters {sorted(evaluation['launches'])}")
    for k in kernels:
        k["launches_by_path"] = {p: r["launches"][k["name"]] for p, r in slices.items()}
        k["launches_by_path"]["evaluation"] = evaluation["launches"][k["name"]]
        k["launches_by_path"]["data_parallel"] = data_parallel["launches"][k["name"]]
        k["launches_by_path"]["spatial"] = spatial["launches"][k["name"]]
        k["launches_by_path"]["cyclegan_spatial"] = cg_spatial["launches"][k["name"]]
        k["launches_by_path"]["migration"] = migration["launches"][k["name"]]
        for label in ("bf16", "bf16_remat_d", "f32_remat_d"):
            k["launches_by_path"][f"sndcgan_{label}"] = options["runs"][label]["launches"][
                k["name"]]
        if k["name"].startswith("leaky"):  # phase 8a: rank 1's rows, with their base
            base = data_parallel["dropout_base"]
            k["at_rank_rows_with_base"] = {
                "shape_nchw": base["timed_shape_nchw"],
                **base["fwd" if k["name"].endswith("fwd") else "bwd"]}
            k["at_spatial_shard"] = spatial["dropout_shard"][k["name"]]  # phase 9a
            part = "fwd" if k["name"].endswith("fwd") else "bwd"
            k[f"{part}_paths"] = slices["sndcgan"][f"{part}_paths"]
        # The path that runs it; Adam runs on both, and its record's times
        # are the CycleGAN apply's, as are its launches; its bfloat16-moment
        # form runs on the SNDCGAN step with opt_moments="bf16"; the split
        # norm runs on the CycleGAN spatial path alone.
        k["launches"] = k["launches_by_path"][
            "sndcgan" if k["name"].startswith("leaky") else
            "sndcgan_bf16" if k["name"] == "adam_bf16" else
            "cyclegan_spatial" if k["name"] in SPLIT_NAMES else "cyclegan"]
        require(k["launches"] > 0, f"{k['name']}: no launch on its path")
        for p, r in k.get("by_path", {}).items():
            r["launches"] = k["launches_by_path"][p]
    print(json.dumps({"kernels": kernels, "slices": {
        p: {"steps_per_sec": r["perf"][-1]["steps_per_sec"],
            "images_per_sec": r["perf"][-1]["images_per_sec"], "config": r["config"],
            "adam_grad_copies": r["grad_copies"]}
        for p, r in slices.items()}, "sampling_and_fid": offline, "evaluation": evaluation,
        "data_parallel": data_parallel, "spatial": spatial, "cyclegan_spatial": cg_spatial,
        "run_twice": run_twice, "sndcgan_options": options, "profile": profile,
        "cyclegan_bf16_ratios": cg_bf16,
        "migration": migration, "card": card,
        "seconds": time.perf_counter() - t0}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
