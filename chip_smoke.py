#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the kernels from ``routeformer_torch/csrc`` (nvcc, sm_90a).
3. K2 (window attention) against its plain version on the card: bf16
   (B, H, n, d) through its wrapper at the flagship's stage-0 and stage-3
   shapes, a ragged n = 144, d = 64 and n = 49 with d = 16; and as K1
   feeds it, f32 strided views of one (B n, 3C) qkv buffer at stage 0's
   shifted block (16 window kinds) and at stage 2.
4. K1 (fused SwinV2 block) against its plain version at the four stage
   geometries, shifted where the model shifts.
4b. The Hopper GEMM core that K1 and K3 share (``csrc/gemm_sm90.cuh``)
   against ``torch.matmul`` of the same bf16-rounded operands in f32: with
   its TMA producer at the four GEMMs of a SwinV2 block at every stage
   (``K1_GEMMS``), with its converting producer at the Perceive layers' X W,
   dY W^T and row-split X^T dY (with B's column sums) at the frame, video
   and gaze stacks' rows (``K3_GEMMS``).
5. Flagship serving: build the full-width flagship from a seed on the card,
   save it as a serving bundle, load it back and answer three batch-1 and
   one batch-4 request of synthetic GEM-geometry clips; check shapes,
   finiteness and 24 K1 and 24 K2 launches per forward; hold the card's
   forward against a CPU run of the same weights (plain versions,
   exhaustive ProbSparse; SwinV2's stage 2 cut to its first
   ``FLAGSHIP_CPU_PAIRS`` pair on both sides for this comparison); time a
   request with CUDA events. Then one
   batch-1 request with the fused Perceive stack (K3a, 24 launches per
   forward) against the plain-stack request.
5b. K4 (dense flash attention) against its plain version at the DinoV2
   shape (288, 1369, 64) bf16, a causal ragged case, E 104 with E_v 64, and
   f32 inputs; on the ViT's strided (B, L, H, E) views of one qkv buffer
   through ``dot_product_attention`` (one launch, no copy of q, k or v: the
   call allocates its output only), at the DinoV2 shape and a causal
   ragged one; its gradient through its autograd Function against autograd
   of the plain version.
5c. DinoV2 serving: the flagship with the DinoV2 ViT-B/14 @518 backbone
   (``build_dinov2``), through a bundle, three batch-1 and one batch-4
   request; 12 K4 launches and no K1/K2/K3a launch per forward; the card's
   forward against the CPU plain forward (exhaustive; both cut to the first
   ``DINOV2_CPU_DEPTH`` of the 12 ViT blocks for this comparison); request
   times, peak
   memory and one profiled request, with the plain Perceive layers and with
   the fused stack. Then a batch-1 request with the fused stack (K3a runs
   the frame encoder at 1370 tokens: 24 K3a launches per forward, counts
   set to 0 just before) against the plain-stack request, both exhaustive:
   the frame encoder's output and the prediction within 5e-2.
5d. The serving export (``serve.export_model``/``ExportedModel``, the
   kernels as registered ``routeformer::`` ops): the flagship with the
   fused Perceive stack (24 K1, 24 K2, 24 K3a a forward) and DinoV2 with
   the plain layers (12 K4), each exported on the card at a batch-1
   request, reloaded from its bytes with the model's leaves and served:
   launches counted from 0 just before the exported forward and read just
   after, equal to the live forward's; the prediction the same bits as the
   live ``ServingModel``'s, else within ``EXPORT_TOL`` of its max with the
   first differing op named (``name_export_difference``); request ms
   (CUDA events) and device busy time of both routes; export and load
   seconds and the artifact's size.
6. K3a (fused Perceive stack forward) against its plain version at every
   stack geometry of the flagship train step, of the zoo's models in
   phase 7c (``K3_ZOO_GEOMS``) and at the DinoV2 frame encoder's (24,
   1370), eval and train (dropout masks at p = 0.05): bf16 with exhaustive
   ProbSparse and f32 with the real u. With the real u, in f32 and bf16,
   the top-u selections that differ (layer by layer and along the stack),
   how near each was to a tie, and the error where none differs; in f32 a
   selection may differ only at a near-tie. K3b (per-layer backward)
   against the plain backward at the same train and zoo geometries; with
   the real u, in the precision each stack runs, the selection K3b
   differentiated against the one K3a made, every layer of a stack (no
   flip allowed); K3b run twice on the same inputs: the same bits in dx
   and every weight grad. K1/K2 gradients through their autograd
   Functions against autograd of the plain versions.
7. Flagship training with ``ROUTEFORMER_FUSION_KERNEL=1``: two steps at
   batch 16 on synthetic GEM clips at epoch 12; finite metrics, the
   non-backbone parameters move and the frozen backbone does not, and the
   launches per step that the design implies (``PER_STEP``). Step time,
   peak memory, the plain-stack step and one profiled step. Then, over
   four batches, a step with the kernels against a step with the plain
   stack from the same weights, dropout off and exhaustive ProbSparse:
   loss, gradients and the update, with the Perceive stacks in the
   flagship's bf16, with the plain layers rounding as the fused stack
   does, and in f32 (``STEP_TOLS``).
7b. The training run (``ROUTEFORMER_FUSION_KERNEL=1``, batch 16, GEM
   geometry, the flagship at full width, through the driver's pieces:
   ``full_comparison.build_models``/``build_data``/``build_trainer``/
   ``run_epochs``, 3 train batches and 1 val batch an epoch). (1) A
   ``ParallelTrainer`` holding the flagship alone against
   ``build_flagship_training``'s step: the same seed weights, batches and
   generator seeds, dropout off, exhaustive ProbSparse, two steps: the same
   bits, or the first differing tensor and the ops without a deterministic
   implementation named, within phase 7's limits. (2) A cold epoch (the
   backbone in every step, the MC eval, ``maybe_save``, ``save_latest``
   after every step; launches counted from 0 just before and read just
   after: the driver's exact-gelu SwinV2 runs the unfused block, so 0 K1
   and 48 K2/K3a a step and 0 K1 and 24 K2/K3a per eval forward, 16-24
   K3b a step);
   the cold step and the MC eval timed. (3) Resume: a snapshot mid-epoch,
   the next step, and a fresh trainer restoring it and taking the same
   step: loss and parameters bit for bit, or the nondeterministic ops
   named. (4) The MC eval twice: the same bits. (5) One step past the
   unfreeze epoch at batch 16 (or the largest batch that fits): finite,
   non-zero backbone gradients; time and peak memory. (6) Steady epochs
   with ``USE_EMBEDDING_CACHE=device``: epoch 1 fills the memo, epoch 2
   encodes 0 frames and launches 0 K1 (48 K3a a step); the memo's features
   against the backbone's own within 1e-2 of max (and whether bit-equal);
   a steady step's loss against the cold step's on the same batch within
   1e-2 (dropout off, exhaustive); the steady step, the memo's encode and
   gather timed. Each timing line stands beside the card's name and power
   limit.
7f. First, in one process, a kept column split's dropout
   (``mesh.split_dropout``) against one process's ``F.dropout`` from one
   generator state: ``full_comparison``'s Informer encoder ff1 output at batch 16
   ((16, 40, 3328), bf16 and f32, p = 0.1) cut into two column blocks and
   put back together: the same kept positions and the same bits (the f32
   draw it replaced read beside it). Then the mesh (``parallel/mesh.py``)
   over NCCL at world size 1 (the card's
   machine has one H100: several cards are held on the CPU over gloo,
   ``tests/test_torch_mesh_train.py``): the driver's flagship at phase 7b's
   settings and batches (``build_models``/``build_data``/``build_trainer``
   with ``mesh=``), as a ``(1, 1)`` mesh and with ``FSDP=1``, two steps
   each with the same generator seeds as a trainer without a mesh: loss and
   parameters the same bits, else the first step's loss within phase 7's
   limit and the nondeterministic op named (both pairs of steps again the
   same bits with it held deterministic); launches per step counted from 0
   just before and read just after (0 K1, 48 K2, 48 K3a, 16-24 K3b); the MC
   eval of a val batch, before the steps, the same bits. The plain mesh
   also: a snapshot, the next step, and a fresh trainer on the mesh
   restoring it and taking that step, cuDNN's convolution backward held
   deterministic: the same bits; its step time and peak memory beside the
   card's name and power limit. (At one data shard FSDP shards nothing, so
   its run is the plain mesh's layout, which it asserts; the op the plain
   mesh named stands for it, and its snapshot and timing are left out for
   the smoke's time.) The mesh gathers one unit at a time (a SwinV2 block pair,
   a Perceive stack, a layer); at world 1 no parameter is sharded, so no
   unit gathers (``gather_units`` 0, gathered bytes 0). Then the ``model``
   axis computing tensor-parallel on two ranks sharing the one card
   (``two_rank_phase``): two processes (``parallel.dryrun.launch``) over
   gloo, each with its tensors and kernels on the card, the driver's
   flagship quiet (dropout off, exhaustive ProbSparse) on a ``(1, 2)`` mesh
   at ``min_shard_dim`` 512 (its split layers compute on their blocks),
   one step of phase 7b's batch-16 batches against the same step without
   a mesh: within phase 7's bf16 limits (``step_gap``), the first
   differing op named; on each rank 0/48/48/16-24 K1/K2/K3a/K3b, each
   split layer's forward FLOPs exactly half the no-mesh step's
   (``counting_flops``), the gathered
   high-water within the largest unit's without the split weights; step
   ms and peak, labelled as two ranks sharing one card over gloo, not a
   multi-card time. In the same two ranks (``zoo_two_rank``): the
   Autoformer, FEDformer Fourier and FEDformer Wavelets GPS backbones at
   the flagship's GPS widths, f32, quiet, one step each of a batch of 16
   synthetic series on the (1, 2) mesh (their layers split, the data
   reductions under the backward) against the no-mesh step the parent
   takes on the card: loss and every gradient within 1e-5 (or twice the
   no-mesh step's own movement under a one-ulp change of its input, where
   larger), each split layer's forward FLOPs exactly half, no split weight
   gathered over ``model``; then FEDformer Fourier on a (2, 1) data mesh
   over the same processes (8 rows a rank, its replicated gradients
   all-reduced in buckets under the backward): the same limits and a
   reduction launched before the backward returned; step ms, peak and the
   gathered high-water per rank.
7c. The driver's whole model zoo (``MODEL_SET=full``, the JAX driver's 13
   models, ``ROUTEFORMER_FUSION_KERNEL=1``, batch 16, GEM geometry, full
   width) through ``build_models``/``build_data``/``build_trainer``/
   ``run_epochs``: one epoch of 2 train batches and 1 val batch, the
   launches counted from 0 just before and read just after and attributed
   to each model per step and per eval forward (``FULL_SET_DESIGN``: K2 24
   a backbone call, K3a 8 a Perceive stack, K3b 8 a trained stack, 0 K1
   and 0 K4); finite metrics, every trained model's parameters move, the
   frozen backbones do not, the baselines have no parameters. The
   full-set step (CUDA events, after a warm-up), its device busy time and
   idle share, peak memory, the MC eval per val batch; the autoregressive
   model's MC eval twice (the same bits); every (rows, tokens, precision) that K3a and K3b ran at in the epoch is
   one phase 6 checked (``StackShapes``); each model whose class or config
   path the zoo added against its CPU plain forward at batch 1
   (``FULL_NEW_MODELS``, exhaustive, the clip moved to its last fix,
   5e-2; not AdaptedGIMO and the MultiModalTransformer, for time); and
   ``USE_PATCHTST_BACKBONE=1``: one step of the flagship over
   PatchTST (finite, BatchNorm statistics moved) and its card forward
   against the CPU (``CardVsCpu`` with witnesses: its GPS backbone's input
   and PatchTST on the card's input within 5e-2, end to end within
   ``PATCHTST_E2E_TOL``; the card's and the CPU's own movement under a
   relative 2^-9 change of the visual features, and the card with the
   fused stack off, are reported).
7d. The GEM data path (``DATASET=GEM``, ``ROUTEFORMER_FUSION_KERNEL=1``,
   batch 16): a recording written by ``io/gem_fixture.py`` into a temporary
   directory (subjects 001 and 003 train, 46 s each, 002 val, 62 s, at 5
   fps, GoPro (540, 960) and world (544, 540) as raw RGB24 MP4s, 3.2 GB; the
   duration halved while the disk cannot hold it twice), indexed through
   the driver's ``build_data`` at scaling 0.4 and 0.6 (the model sees the
   driver's real GEM geometry, GoPro crop (216, 153) and front (326, 324)):
   the train and val counts equal the windows the durations and the PCI
   filter predict. The loader alone (``to_device``, ``h2d_dedup``), two
   epochs: every batch against ``torch.from_numpy`` of the numpy collate
   of its samples, the same bits; samples/s, ms a batch, bytes copied a
   batch, shipped share; each window's frames give distinct content keys
   and no key is shared between subjects; host ms a source frame for the
   raw read, the undistort and the resize; a batch's pinned and pageable
   copy rates. Then a cold epoch of the driver's flagship through
   ``run_epochs`` on ``build_data``'s loaders (2 train batches, 1 val batch,
   MC eval; launches counted from 0 just before and read just after: 0 K1,
   48 K2 and K3a a step, 24 per eval forward, 16-24 K3b a step; finite
   metrics; peak memory; profiled copy and busy device time), and the
   steps again on the loader's pinned batches and on the same batches as
   numpy through the trainer's pageable copy: step ms, device busy, idle
   share, copy device time, launches per step. Then audio and GPMF on the
   same recording (``gem_audio_path``): PCM tracks added to its nine
   videos; every GPMF track through the native walker
   (``io/gpmf_native.py``) and the Python one, the same points, and the
   index's seconds with each; ``GEMDataset(with_audio=True)`` (the val
   subject) through the loader onto the card for one epoch, every placed
   batch the same bits as the numpy collate of its samples; an
   information line says whether the AAC shim (``csrc/audio.cpp`` over
   ffmpeg) builds on this machine (a probe, no check).
7e. The DR(eye)VE data path (``DATASET=DREYEVE``, batch 16): sessions
   written by ``io/dreyeve_fixture.py`` into a temporary directory (01 and
   02 train, 45 val, 54 s each; only the frames the windows read, as BMP
   content under ``.jpg`` names: the garmin view at (540, 960), the ETG at
   (720, 960), 2.9 GB; the duration halved while the disk cannot hold it
   twice), indexed through the driver's ``build_data`` with garmin scaling
   0.8 (the general ``INTER_AREA`` path, as the real 0.4 takes it) and ETG
   1/3 (the integer one): the model sees the driver's real DR(eye)VE
   geometry, garmin (432, 768) cropped to 216 rows and split into two
   (216, 384) halves, ETG (240, 320). Windows per session and the val count
   at ``MIN_PCI``; the loader alone with the driver's placed split stage,
   two epochs: every batch the same bits as the numpy collate of its
   samples, split in numpy; the halves views of one placed tensor; each
   window's frames distinct keys, none shared between sessions; host ms a
   source frame (the read, ``INTER_AREA`` per view); the loader's rates and
   shipped share. Then a cold epoch of the driver's flagship (2 train
   batches, MC eval of 1 val batch; launches from 0 just before and read
   just after, 0/48/48/16-24 K1/K2/K3a/K3b a step), the steps again on the
   loader's batches (step ms, busy, idle share, launches per step), and
   the card's ``ops/image.remap`` against the CPU's on a batch of frames
   warped by a fixed homography (the stitcher's warp), timed.
7i. Gaze heatmaps (``ops/heatmap.py``, ``visualize/gaze.py``) on one
   placed batch of phase 7d's GEM loader and one of 7e's DR(eye)VE loader
   (its gaze with the logs' NaN gaps): each front-camera frame's gaze
   samples as the batch carries them, at the driver's front geometry,
   rasterized on the card and with ``device="cpu"``: the same NaN mask
   (a NaN sample makes its frame's map NaN, as in JAX; the loaders'
   gaze is interpolated, so one sample of one frame is set to NaN on
   both sides, and only that frame turns NaN), within
   ``HEATMAP_TOL`` of the max where finite, ms per batch (CUDA events);
   ``visualize.gaze.overlay_heatmap_on_frame`` on the card against the
   CPU's on the clip's first ``HEATMAP_OVERLAY_FRAMES`` uint8 frames: at
   most 1 level apart, but for pixels whose heat lies within
   ``HEATMAP_TOL`` of the 0.2 mask (counted: there the two sides may fall
   either way). An information line says whether matplotlib imports and,
   where it does, renders the batch's first trajectory with
   ``plot_gps_data_on_map`` (no check).
7g. The zoo's remainder (``ROUTEFORMER_FUSION_KERNEL=1``, batch 16): the
   flagship (tanh SwinV2) with its GPS backbone swapped at
   the driver's full GPS width (d_model 832, 8 heads, e6/d1, d_ff 3328,
   factor 4, moving average 25) for Autoformer, FEDformer ``Fourier`` and
   FEDformer ``Wavelets`` (32 modes), and the flagship with InverseForm
   (HRNet-16) as its video backbone, on frames at the driver's real GEM
   geometry in uint8 (``GEM_MODEL_HW``: InverseForm reads them at their own
   size; the SwinV2 variants take (54, 96) frames, as they resize every
   frame to 256), each through
   ``build_flagship_training(gps=, video=)``: a batch-16 request through
   ``ServingModel`` (launches from 0 just before and read just after:
   ``ZOO_PER_FORWARD``), three train steps at batch 16 (launches per step
   held to ``ZOO_PER_STEP``; finite metrics; the trained parameters move,
   the frozen backbone does not), the mean time of the two after the first
   (CUDA events), a profiled step's device busy time and idle share, and
   peak memory; for the FEDformer variants (``ZOO_CPU_VARIANTS``) the
   batch-1 card forward against the CPU plain forward (``CardVsCpu``,
   PRED_TOL; SwinV2's stage 2 cut to its first pair on both sides), whose
   CPU references run in a thread beside phase 7h's untimed first part;
   for Autoformer (``ZOO_GPS_CPU_VARIANTS``) its GPS backbone alone, the
   card's batch-1 forward's backbone input through a CPU copy of the
   backbone against the card's output (PRED_TOL).
   The FEDformer Fourier variant (``ZOO_EXPORTS``) is
   exported (``export_model``) and reloaded from its bytes: its batch-1
   prediction the live ``ServingModel``'s bits, else within ``EXPORT_TOL``
   of the max with the first differing op named, and the live forward's
   launches (``zoo_export``).
7h. Backbone training (``train_backbone=True``), through
   ``build_flagship_training(video=, train_backbone=True)``, dropout off
   and exhaustive ProbSparse: the tanh SwinV2 (K1), the driver's
   exact-gelu SwinV2 (K2) and DinoV2 at 518 px (K4; its 1370-token frame
   encoder above K3b's 208 takes ``ROUTEFORMER_FUSION_KERNEL=hybrid``). Its parameters are the
   optimizer's ``video_backbone`` group. First, per variant and untimed,
   beside the CPU references: loss and backward with remat off
   at the largest batch that fits (from 16, DinoV2 from 2, halved on an
   out-of-memory error) and with remat on at that batch, the augment's draws shared
   (``SharedDraws``): the loss within ``REMAT_LOSS_TOL`` and every
   gradient within ``REMAT_GRAD_TOL`` of the largest, the backbone's
   gradient norm finite and non-zero, the variant's kernel launched more
   under remat; and (SwinV2 only: DinoV2's is left out for time) the first
   step's batch-1 loss on the card, whose CPU
   plain step with the same draws (the backbone cut to
   ``BACKBONE_CPU_DEPTH`` on both sides) runs in a worker thread. Then the
   CPU references are joined (7g's within PRED_TOL, the first-step losses
   within ``BACKBONE_LOSS_TOL``), and per variant, rebuilt, three optimizer
   steps each way (remat on from batch 16, DinoV2 from 4) at the largest
   batch that fits: launches per step, the backbone's largest movement
   (non-zero), the mean time of the two after the first and peak memory.
8. Print a ``kernels`` JSON line: launches on each kernel's path (K1-K3b
   the two train steps, K4 the four DinoV2 requests), per train step and
   per serving forward; K1/K2 times per batch-1 forward, K3a/K3b per train
   step, K4 per batch-1 DinoV2 forward; bound and library time.
   ``training_run_launches`` gives K1-K4's launches in phase 7b's cold
   and steady epochs, ``full_set_launches`` those of phase 7c per full-set
   step and per eval forward (one MC sample of every model),
   ``gem_data_path_launches`` those of phase 7d's cold epoch,
   ``dreyeve_data_path_launches`` those of phase 7e's,
   ``mesh_launches_per_step`` those of phase 7f's mesh steps,
   ``export_launches_per_forward`` those of phase 5d's exported forward
   (the flagship's for K1-K3b, DinoV2's for K4),
   ``zoo_launches_per_step`` those of phase 7g's steps per variant and
   ``backbone_training_launches_per_step`` those of phase 7h's. ``ms_timing``
   says how each ``ms`` was taken: ``eager`` (back-to-back
   calls, the host's launch time included where it exceeds the kernel's)
   or ``graph`` (device time, the launches replayed from a CUDA graph).
   K2's ``ms`` is the path's variant (f32 strided views with each block's
   window kinds) as graph time, because at stages 2-3 the wrapper's host
   time exceeds the kernel's; ``bf16_ms`` is the bf16 (B, H, n, d)
   wrapper's graph time and ``bf16_eager_ms`` its eager time, through its
   autograd Function as the serving path calls it. K1's ``gemm_ms`` is the
   core's time for the block's four GEMMs per forward and
   ``gemm_library_ms`` the same four through ``F.linear`` (cuBLAS, bf16; a
   yardstick the port never calls), eager, and ``gemm_graph_ms`` /
   ``gemm_library_graph_ms`` as device time; ``gemm_stage_ms`` per stage. K3a's
   and K3b's ``attention_ms``, ``gemm_ms`` and ``rows_ms`` split their device
   time (torch.profiler) into the attention core, the GEMMs and the row
   kernels (LayerNorms, the fixed-order reduction). K3a is timed as the
   fused stack calls it, all 8 layers in one call; its ``dinov2_*`` keys
   give the DinoV2 frame encoder's stack per batch-1 forward.
9. Print ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX. Timings are back-to-back launches (warm L2).
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BUNDLE_DIR = ROOT / "build" / "smoke_bundle"

# Phase 7i takes one placed batch of each data path (7d, 7e), kept on the
# host (``heatmap_batch``): its gaze (every frame's samples), its GPS and
# the first clip's front frames.
HEATMAP_SIGMA = 10.0
HEATMAP_TOL = 1e-5  # of the max where finite: f32 sums over the samples reordered
HEATMAP_OVERLAY_FRAMES = 16

# K1/K2 geometry per flagship forward at batch 1 (24 frames):
# (name, windows, tokens, channels, heads, blocks per forward, window kinds
# of the shifted block or None where the window covers the feature map).
STAGES = [
    ("stage0", 384, 256, 128, 4, 2, 16),
    ("stage1", 96, 256, 256, 8, 2, 4),
    ("stage2", 24, 256, 512, 16, 18, None),
    ("stage3", 24, 64, 1024, 32, 2, None),
]
K2_TOL = 1e-2  # max |kernel - plain| / max(1, max |plain|), bf16 output
# K2 through its wrapper, bf16 (windows, heads, tokens, head width, window
# kinds): the flagship's stage-0 and stage-3 shapes, a ragged n = 144,
# d = 64 and n = 49 with d = 16.
K2_CASES = [(384, 4, 256, 32, 16), (24, 32, 64, 32, 1), (384, 4, 144, 32, 16),
            (16, 4, 256, 64, 4), (32, 4, 49, 16, 2)]
# K2 as K1 feeds it (windows, tokens, channels, heads, window kinds): f32
# strided views of the qkv GEMM's output at stage 0's shifted block and at
# stage 2.
K2_PATH_CASES = [(384, 256, 128, 4, 16), (24, 256, 512, 16, 1)]
K1_TOL = 1e-2  # max |kernel - plain| / max |plain|, bf16 output
# The GEMM core against torch.matmul of the same bf16 values in f32, of the
# output's max: f32 outputs differ by sums in another order, bf16 ones by a
# rounding of the output.
GEMM_TOL_F32, GEMM_TOL_BF16 = 1e-4, 1e-2
# B's column sums of a row-split X^T dY, of the largest column's sum of |B|.
COLSUM_TOL = 1e-5
# The Perceive layers' GEMMs at every stack geometry: (name, M, N, K, A
# given transposed, B given transposed, split over K): X W, dY W^T, and the
# weight grads X^T dY split over the M rows (M, N, K as the product's).
K3_GEMMS = [("x W", "M", "D", "D", False, False, False),
            ("x Wff1", "M", "F", "D", False, False, False),
            ("a1 Wff2", "M", "D", "F", False, False, False),
            ("df2 Wff2^T", "M", "F", "D", False, True, False),
            ("df1 Wff1^T", "M", "D", "F", False, True, False),
            ("x0^T dqkv", "D", "3D", "M", True, False, True),
            ("a1^T df2", "F", "D", "M", True, False, True),
            ("xn1^T df1", "D", "F", "M", True, False, True)]


def k1_gemms(c: int) -> list:
    """A SwinV2 block's four GEMMs for C channels, (N, K, act, output
    dtype): qkv, proj, fc1 (tanh gelu), fc2."""
    return [(3 * c, c, 0, "float32"), (c, c, 0, "float32"),
            (4 * c, c, 1, "bfloat16"), (c, 4 * c, 0, "float32")]
FEATURE_TOL = 5e-2  # backbone feature maps, card vs CPU, relative to max
# The serving card-vs-CPU comparisons cut the backbone on both sides: the
# CPU forward is their cost. DinoV2 keeps its first ViT block of 12 (all
# twelve took 77.9 s, three 24.3 s); the flagship's SwinV2 its first
# stage-2 pair of 9 (8 of the 24 blocks; all took 13.1 s).
DINOV2_CPU_DEPTH = 1
FLAGSHIP_CPU_PAIRS = 1
PRED_TOL = 5e-2  # displacement and dense features, card vs CPU, relative to max
# The PatchTST flagship end to end, card vs CPU at batch 1 (phase 7c).
# RevIN divides each of its input channels by its spread over the 40
# steps, and the visual channels vary little over time, so the prediction
# is ill-conditioned in the visual features. PATCHTST_E2E_TOL is twice the
# largest reading of ``CardVsCpu``'s three witnesses on the H100 and its
# host, rounded up: the model's own movement when its video encoder's
# output moves by a relative 2^-9 (half a bf16 ulp) of seeded noise, on
# the CPU (2.4e-2, dense 8.7e-2) and on the card (4.1e-2, 8.4e-2), and the
# card with the fused stack off against the CPU (3.8e-2, 1.4e-1).
PATCHTST_E2E_TOL = {"displacement": 1e-1, "dense": 3e-1}

# The Perceive stacks at the flagship train step, batch 16: (encoder, rows,
# tokens, stack calls per step). Each encoder runs on the input and,
# detached, on the target; the gaze encoder's geometry is the same in both.
K3_GEOMS = [("frame", 384, 65, 1), ("frame target", 288, 65, 1),
            ("video", 16, 160, 1), ("video target", 16, 120, 1),
            ("gaze", 16, 40, 2)]
K3_BACKWARD = {"frame", "video", "gaze"}  # the stacks that backpropagate
# The zoo's stacks beyond those (phase 7c, batch 16, the same widths): the
# scene-less model's (front view only: 8 and 6 frames a clip, video
# tokens 80 and 60) and the gaze-less model's (two scene views: 16 and 12
# frames, 120 and 90 tokens), input and target pass; AdaptedGIMO's and the
# MultiModalTransformer's f32 frame encoder on one view of 40 frames,
# three calls a model. K3b is checked at every one of them, the detached
# target lengths too (each its own ragged 64-key tail).
K3_ZOO_GEOMS = [("wout_scene frame", 128, 65, 1), ("wout_scene frame target", 96, 65, 1),
                ("wout_scene video", 16, 80, 1), ("wout_scene video target", 16, 60, 1),
                ("with_video frame", 256, 65, 1), ("with_video frame target", 192, 65, 1),
                ("with_video video", 16, 120, 1), ("with_video video target", 16, 90, 1),
                ("gimo/mmt frame", 640, 65, 6)]
K3_F32 = {"gimo/mmt frame"}  # stacks that run in f32 (compute_dtype None)
# Where K3b's selection and determinism are checked: the flagship's
# backward stacks and every zoo stack.
K3_BACKWARD_GEOMS = [g for g in K3_GEOMS if g[0] in K3_BACKWARD] + K3_ZOO_GEOMS
# The DinoV2 frame encoder's stack at batch-1 serving (K3a only: K3b's
# attention block takes at most 208 tokens), once per forward.
K3_DINO = ("dinov2 frame", 24, 1370, 1)
K3_D, K3_F, K3_H, K3_N, K3_FACTOR, K3_P = 128, 256, 8, 8, 5, 0.05
K3A_TOL = 2e-2  # max|kernel - plain| / max|plain| (the JAX fused-stack forward parity)
K3B_TOL = 5e-2  # dx against its max, weight grads against one global scale
# f32 with the real u: the error where no selection differs (of max|plain|),
# and the largest distance of a differing selection from the top-u
# boundary (of max|measure|): an f32 near-tie.
K3A_F32_CLEAN_TOL, K3A_F32_TIE = 1e-4, 1e-4
# bf16 with the real u, each layer from the plain layer input: the kernel's
# q and k are its own QKV GEMM's f32 sums rounded to bf16, so one may land
# one bf16 ulp from the plain version's and move the measure by about that
# much: a selection may differ only within 2^-8 of the max measure of the
# boundary (H100 readings <= 1.4e-3); the tokens where none differs within
# 1e-2 of max|plain| (the K1/K2/K4 bf16 limit; readings <= 3.1e-3).
K3A_BF16_CLEAN_TOL, K3A_BF16_TIE = 1e-2, 2 ** -8
K12_GRAD_TOL = 1e-2  # the Functions' gradients against autograd of the plain versions
# K4 on the DinoV2 serving path at batch 1: 24 frames x 12 heads, 1369
# tokens, head width 64, one launch per ViT block.
K4_SHAPE = (288, 1369, 64)
K4_PER_FORWARD = 12
# K3a per serving forward with the fused stack: the frame, video and gaze
# encoders' 8 layers each (the DinoV2 frame encoder's at 1370 tokens).
K3A_PER_FORWARD = 24
K4_TOL = 1e-2  # max|kernel - plain| / max|plain|, as K1/K2
# (BH, L, E, E_v, causal, dtype): the main shape, a causal ragged length,
# E not a multiple of 16 with a narrower E_v, and f32 inputs.
K4_CASES = [(288, 1369, 64, 64, False, "bfloat16"), (6, 700, 64, 64, True, "bfloat16"),
            (8, 600, 104, 64, False, "bfloat16"), (12, 577, 64, 64, True, "float32"),
            (12, 577, 64, 64, False, "float32")]
# (B, L, H, E, causal): K4 on the ViT's views of its qkv rows at the DinoV2
# shape and a causal ragged one.
K4_VIEW_CASES = [(24, 1369, 12, 64, False), (3, 700, 4, 64, True)]
TRAIN_BATCH, TRAIN_EPOCH = 16, 12  # epoch >= 10: lr > 0, dense loss on
# Launches per flagship train step: 24 SwinV2 blocks (K1, each with one K2)
# in the input and in the target backbone pass; 3 Perceive stacks of 8
# layers (K3a, one launch per layer) in each pass; K3b once per layer of
# the input-pass stacks that receive a gradient (the target pass is
# detached): all 3, or the frame and video encoders' when gaze dropout
# zeroes the gaze features (one decision per batch, p = 0.2), which cuts
# the gaze encoder out of the backward.
PER_STEP = {"K1": (48,), "K2": (48,), "K3a": (48,), "K3b": (24, 16), "K4": (0,)}
STEP_LOSS_TOL = 1e-2  # kernel vs plain-stack step: relative loss
STEP_GRAD_TOL = 5e-2  # kernel vs plain-stack step: gradients, of the global max
# The gradient limit by how the Perceive stacks compute (``set_stacks``).
# With bf16 stacks (the flagship), the plain step's own gradients move by
# 1.9e-2 to 5.3e-2 of the max when the encoders' outputs move by one f32
# ulp (``PARITY_PAIRS`` "plain 2^-23" on the H100 over PARITY_SEEDS), and
# the kernel step's gap reads 1.7e-2 to 5.5e-2, with the plain layers
# rounding as the fused stack does too: the limit is twice the largest
# reading. In f32 the kernel gap read at most 1.5e-2 against 5e-2.
STEP_TOLS = {"bf16": 1e-1, "f32out": 1e-1, "f32": STEP_GRAD_TOL}
STEP_UPDATE_SHARE = 3e-2  # updates differing by > 0.1 lr: twice the largest reading
PARITY_SEEDS = (22, 23, 24, 25)  # synthetic batches of the step comparison


T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line on stdout, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def event_ms(fn) -> float:
    """One call of ``fn`` timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want, floor: float = 0.0) -> float:
    err = (got.float() - want.float()).abs().max().item()
    return err / max(floor, want.float().abs().max().item())


# ---------------------------------------------------------------- phase 3 #


def k2_inputs(b, h, n, d, nb, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    bias = 16 * torch.sigmoid(torch.randn(nb, h, n, n, device="cuda", generator=g))
    scale = torch.exp(torch.clamp(
        torch.randn(h, device="cuda", generator=g) * 0.5 + 2.3, max=math.log(100.0)))
    return q, k, v, bias.contiguous(), scale.contiguous()


def k2_path_inputs(b, n, c, h, nb, seed):
    """K2's inputs as K1 hands them over: one f32 (B n, 3C) qkv buffer, the
    bias per window kind and the head scales."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b * n, 3 * c, device="cuda", generator=g)
    bias = 16 * torch.sigmoid(torch.randn(nb, h, n, n, device="cuda", generator=g))
    scale = torch.exp(torch.clamp(
        torch.randn(h, device="cuda", generator=g) * 0.5 + 2.3, max=math.log(100.0)))
    return qkv, bias.contiguous(), scale.contiguous()


def k2_path(qkv, bias, scale, b, n, c, h, out):
    """K2 launched as K1 launches it: q, k, v are strided views of the qkv
    rows ((window, head, token) strides (3 n C, d, 3C)); ``out`` (B n, C)."""
    from routeformer_torch.ops import flash_attention as fa

    d = c // h
    fa.launch_window_attention(qkv, qkv[:, c:], qkv[:, 2 * c:], (n * 3 * c, d, 3 * c), bias,
                               scale, out, (n * c, d, c), b, h, n, d, True)
    return out


def k2_path_plain(qkv, bias, scale, b, n, c, h):
    """The plain version on the same views. The kernel rounds the f32 q and
    k to bf16 after normalising them and v as it reads it, as K1's plain
    version does: a bf16 v selects those rounding points."""
    from routeformer_torch.ops import flash_attention as fa

    q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(b, n, h, c // h).transpose(1, 2)
               for i in range(3))
    out = fa.flash_window_attention_plain(q, k, v.bfloat16(), bias, scale, cosine=True)
    return out.transpose(1, 2).reshape(b * n, c)


def check_k2(results: dict) -> float:
    import torch

    from routeformer_torch.ops import flash_attention as fa

    worst = 0.0

    def hold(label, got, want):
        nonlocal worst
        err = rel_err(got, want, floor=1.0)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        log(f"K2 {label}: max|kernel-plain|/max(1,|plain|) = {err:.3e}")
        if not err <= K2_TOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err} > {K2_TOL}")

    for b, h, n, d, nb in K2_CASES:
        q, k, v, bias, scale = k2_inputs(b, h, n, d, nb, seed=n + d)
        got = fa.flash_window_attention(q, k, v, bias, scale, cosine=True)
        want = fa.flash_window_attention_plain(q, k, v, bias, scale, cosine=True)
        hold(f"bf16 {(b, h, n, d)} nb={nb}", got, want)
    for b, n, c, h, nb in K2_PATH_CASES:
        qkv, bias, scale = k2_path_inputs(b, n, c, h, nb, seed=c)
        out = torch.empty(b * n, c, dtype=torch.bfloat16, device="cuda")
        got = k2_path(qkv, bias, scale, b, n, c, h, out)
        hold(f"f32 strided {(b, h, n, c // h)} nb={nb}", got,
             k2_path_plain(qkv, bias, scale, b, n, c, h))
        del qkv, bias, out, got
    results["k2_max_abs_err"] = worst
    return worst


# ---------------------------------------------------------------- phase 4 #


def k1_inputs(b, n, c, h, nw, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=0.15):
        return torch.randn(*shape, device="cuda", generator=g) * s

    params = {
        "wqkv": rnd(3 * c, c, s=c ** -0.5), "bqkv": rnd(3 * c),
        "wproj": rnd(c, c, s=c ** -0.5), "bproj": rnd(c),
        "ln1_scale": 1 + rnd(c, s=0.05), "ln1_bias": rnd(c, s=0.05),
        "wfc1": rnd(4 * c, c, s=c ** -0.5), "bfc1": rnd(4 * c),
        "wfc2": rnd(c, 4 * c, s=(4 * c) ** -0.5), "bfc2": rnd(c),
        "ln2_scale": 1 + rnd(c, s=0.05), "ln2_bias": rnd(c, s=0.05),
        "logit_scale": torch.exp(torch.clamp(rnd(h, s=0.5) + 2.3, max=math.log(100.0))),
    }
    x = torch.randn(b, n, c, device="cuda", generator=g).bfloat16()
    bias = 16 * torch.sigmoid(rnd(h, n, n, s=1.0))
    if nw is not None:  # shifted block: CPB bias + a -100 mask per window kind
        mask = torch.where(torch.rand(nw, n, n, device="cuda", generator=g) < 0.2,
                           -100.0, 0.0)
        bias = bias[None] + mask[:, None]
    return x, params, bias.contiguous()


def check_k1(results: dict) -> float:
    from routeformer_torch.ops import swin_block_fusion as sbf

    worst = 0.0
    for name, b, n, c, h, _, nw in STAGES:
        for kinds in ([None, nw] if nw else [None]):
            x, params, bias = k1_inputs(b, n, c, h, kinds, seed=c + (kinds or 0))
            got = sbf.fused_swin_block(x, params, bias, h, True)
            want = sbf.fused_swin_block_plain(x, params, bias, h, True)
            err = rel_err(got, want)
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            log(f"K1 {name} {(b, n, c)} H={h} kinds={kinds or 1}: "
                f"max|kernel-plain|/max|plain| = {err:.3e}")
            if not err <= K1_TOL:
                raise AssertionError(f"K1 disagrees with its plain version: {err} > {K1_TOL}")
    results["k1_max_abs_err"] = worst
    return worst


# --------------------------------------------------------------- phase 4b #


def k1_gemm_inputs(m, n, k, dtype, seed):
    """Operands of one K1 GEMM: bf16 a (M, K), bf16 w (N, K), f32 bias, and
    the output buffer of the pipeline's type."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
    w = (torch.randn(n, k, device="cuda", generator=g) * k ** -0.5).bfloat16()
    bias = torch.randn(n, device="cuda", generator=g) * 0.1
    return a, w, bias, torch.empty(m, n, dtype=getattr(torch, dtype), device="cuda")


def check_gemm_core(results: dict) -> None:
    """The GEMM core against ``torch.matmul`` of the same bf16 values in f32:
    the TMA producer at every K1 GEMM of the four stages (batch-1 rows), the
    converting producer at the Perceive GEMMs of every stack geometry."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs
    from routeformer_torch.ops import swin_block_fusion as sbf

    worst = {"k1_f32": 0.0, "k1_bf16": 0.0, "k3": 0.0, "k3_colsum": 0.0}
    for name, b, n_tok, c, _, _, _ in STAGES:
        m = b * n_tok
        for n, k, act, dtype in k1_gemms(c):
            a, w, bias, out = k1_gemm_inputs(m, n, k, dtype, seed=n + k)
            got = sbf.gemm_bias_act(a, w, bias, out, act)
            err = rel_err(got, sbf.gemm_bias_act_plain(a, w, bias, act))
            key, tol = (("k1_bf16", GEMM_TOL_BF16) if dtype == "bfloat16"
                        else ("k1_f32", GEMM_TOL_F32))
            worst[key] = max(worst[key], err)
            log(f"GEMM core, TMA, K1 {name} (M {m}, N {n}, K {k}) act={act} {dtype}: "
                f"max|core-matmul|/max|matmul| = {err:.3e}")
            if not err <= tol:
                raise AssertionError(f"the GEMM core disagrees with matmul: {err} > {tol}")
            del a, w, bias, out, got
    sizes = {"D": K3_D, "F": K3_F, "3D": 3 * K3_D}
    for geom, r, l, _ in K3_GEOMS:
        sizes["M"] = r * l
        g = torch.Generator(device="cuda").manual_seed(r * l)
        for label, ms, ns, ks, a_t, b_t, split in K3_GEMMS:
            m, n, k = sizes[ms], sizes[ns], sizes[ks]
            a = torch.randn(*((k, m) if a_t else (m, k)), device="cuda", generator=g)
            bt = torch.randn(*((n, k) if b_t else (k, n)), device="cuda", generator=g)
            am, bm = (a.t() if a_t else a), (bt.t() if b_t else bt)
            want, _ = fs.gemm_core_plain(am, bm)
            rows = fs.split_rows(k) if split else None
            if split:
                got, colsum = fs.gemm_core(a, bt, a_t=a_t, b_t=b_t, split=rows)
                cerr = ((colsum - bm.sum(0)).abs().max() / bm.abs().sum(0).max()).item()
                worst["k3_colsum"] = max(worst["k3_colsum"], cerr)
                if not cerr <= COLSUM_TOL:
                    raise AssertionError(f"the core's column sums disagree: {cerr}")
            else:
                got = fs.gemm_core(a, bt, a_t=a_t, b_t=b_t)
            err = rel_err(got, want)
            worst["k3"] = max(worst["k3"], err)
            log(f"GEMM core, converting, K3 {geom} {label} (M {m}, N {n}, K {k}"
                f"{f', {rows} rows a split' if split else ''}): "
                f"max|core-matmul|/max|matmul| = {err:.3e}")
            if not err <= GEMM_TOL_F32:
                raise AssertionError(f"the GEMM core disagrees with matmul: {err} > "
                                     f"{GEMM_TOL_F32}")
            del a, bt, got, want
    results["gemm_core_max_rel_err"] = worst


# ---------------------------------------------------------------- phase 5 #


def set_exhaustive(model) -> None:
    """Every ProbSparse layer selects all queries (u == L): the output then
    does not depend on which keys were sampled."""
    from routeformer_torch.models.layers import ProbAttention

    for m in model.modules():
        if isinstance(m, ProbAttention):
            m.factor = 10 ** 6


def serve_flagship(results: dict) -> dict:
    import torch

    import routeformer_torch as rt
    from routeformer_torch.ops import flash_attention, swin_block_fusion

    t0 = time.perf_counter()
    model = rt.build_flagship(seed=0)  # CUDA by default
    n_params = sum(p.numel() for p in model.parameters())
    rt.save_serving_bundle(BUNDLE_DIR, model)
    cfg = model.configs
    del model
    serving = rt.load_serving_bundle(BUNDLE_DIR)
    shutil.rmtree(BUNDLE_DIR)
    log(f"flagship built, saved and reloaded: {n_params} parameters, "
        f"{time.perf_counter() - t0:.1f} s")

    g = cfg.gps_backbone_config
    requests = serving_requests(cfg)

    # The main path: counts set to 0 just before, read just after.
    swin_block_fusion.launches = 0
    flash_attention.launches = 0
    outs = []
    for batch in requests:
        k1_before, k2_before = swin_block_fusion.launches, flash_attention.launches
        gps, dense = serving(batch)
        torch.cuda.synchronize()
        b = batch["gps"].shape[0]
        assert gps.shape == (b, g.pred_len, 2), gps.shape
        assert dense.shape == (b, g.pred_len, cfg.image_embedding_size), dense.shape
        assert torch.isfinite(gps).all() and torch.isfinite(dense).all()
        per = (swin_block_fusion.launches - k1_before, flash_attention.launches - k2_before)
        assert per == (24, 24), f"K1/K2 launches per forward {per}, expected (24, 24)"
        outs.append((gps, dense))
    launches = {"K1": swin_block_fusion.launches, "K2": flash_attention.launches}
    results["serve_launches_per_forward"] = {"K1": per[0], "K2": per[1]}
    log(f"served 3 x batch 1 and 1 x batch 4: shapes ok, finite, launches {launches}")

    # Time per request after warm-up, and peak memory.
    timing = {}
    for b, batch in ((1, requests[0]), (4, requests[3])):
        torch.cuda.reset_peak_memory_stats()
        timing[b] = cuda_ms(lambda: serving(batch), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"request batch {b}: {timing[b]:.2f} ms, peak memory {peak:.2f} GiB")
        results[f"request_ms_b{b}"] = timing[b]
        results[f"peak_gib_b{b}"] = peak

    results["profile"] = profile_request(serving, requests[0], results["request_ms_b1"])
    results["card_vs_cpu"] = card_vs_cpu(serving, "final_norm", requests[0],
                                         depth=FLAGSHIP_CPU_PAIRS)
    serve_fused(serving, requests[0], results)
    return launches


def card_vs_cpu(serving, norm: str, batch, depth=None) -> dict:
    """The card's forward against a CPU run of the same weights (plain
    kernel versions), exhaustive ProbSparse: max|diff|/max|cpu| of the
    backbone features (the output of its final norm ``norm``), the
    displacement and the dense features, held to FEATURE_TOL and PRED_TOL.
    ``depth`` cuts the backbone in both models for this comparison
    (``cut_depth``: a ViT's first blocks, SwinV2's first stage-2 pairs; the
    CPU's backbone forward is the cost)."""
    import torch

    import routeformer_torch as rt

    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = rt.models.Routeformer(serving.model.configs,
                                      video_backbone=type(serving.model.video_backbone))
    cpu_model.load_state_dict(serving.model.state_dict())
    cpu_model.eval()
    set_exhaustive(cpu_model)
    set_exhaustive(serving.model)
    restore = cut_depth(serving.model, depth) if depth else None
    if depth:
        cut_depth(cpu_model, depth)
    try:
        return _card_vs_cpu(serving, cpu_model, norm, batch)
    finally:
        if restore is not None:
            restore()


def _card_vs_cpu(serving, cpu_model, norm: str, batch) -> dict:
    import numpy as np
    import torch

    feats = {}

    def capture(key):
        def hook(_module, _inp, out):
            feats[key] = out.detach().float().cpu()
        return hook

    hooks = [getattr(m.video_backbone, norm).register_forward_hook(capture(key))
             for key, m in (("gpu", serving.model), ("cpu", cpu_model))]
    gps_gpu, dense_gpu = serving(batch)
    t0 = time.perf_counter()
    with torch.inference_mode():
        gps_cpu, dense_cpu = cpu_model({k: torch.from_numpy(v) for k, v in batch.items()})
    log(f"CPU reference forward (batch {batch['gps'].shape[0]}): "
        f"{time.perf_counter() - t0:.1f} s")
    for h in hooks:
        h.remove()
    last = torch.from_numpy(batch["gps"][:, -1:])
    errs = {
        "features": rel_err(feats["gpu"], feats["cpu"]),
        "displacement": rel_err(gps_gpu.cpu() - last, gps_cpu - last),
        "dense": rel_err(dense_gpu.cpu(), dense_cpu),
    }
    log("card vs CPU, max|diff|/max|cpu|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert errs["features"] <= FEATURE_TOL, errs
    assert errs["displacement"] <= PRED_TOL and errs["dense"] <= PRED_TOL, errs
    assert np.isfinite(list(errs.values())).all()
    return errs


def serve_fused(serving, batch, results: dict) -> None:
    """One batch-1 request with the fused Perceive stack (K3a) against the
    plain-stack request, both exhaustive; K3a launches per forward."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    set_fusion("0")
    gps_plain, dense_plain = serving(batch)
    plain_ms = cuda_ms(lambda: serving(batch), iters=3, warmup=1)
    set_fusion("1")
    fs.launches_fwd = fs.launches_bwd = 0  # set to 0 just before, read just after
    gps, dense = serving(batch)
    torch.cuda.synchronize()
    per_forward = fs.launches_fwd
    results["serve_launches_per_forward"].update(K3a=per_forward, K3b=fs.launches_bwd)
    fused_ms = cuda_ms(lambda: serving(batch), iters=3, warmup=1)
    set_fusion("0")
    last = torch.as_tensor(batch["gps"][:, -1:], device=gps.device)
    errs = {"displacement": rel_err(gps - last, gps_plain - last),
            "dense": rel_err(dense, dense_plain)}
    log(f"batch-1 request with the fused stack: {per_forward} K3a launches, "
        f"{fused_ms:.2f} ms (plain stack {plain_ms:.2f} ms); fused vs plain stack, "
        f"max|diff|/max|plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert per_forward == 24, f"K3a launches per forward {per_forward}, expected 24"
    assert errs["displacement"] <= PRED_TOL and errs["dense"] <= PRED_TOL, errs
    results["serve_fused"] = {"k3a_launches": per_forward, "request_ms": fused_ms,
                              "plain_stack_request_ms": plain_ms, **errs}


def profile_request(serving, batch, request_ms: float) -> dict:
    """Device time by kernel over two requests (torch.profiler), each
    kernel's share of it, and the device's idle share of the request time
    ``request_ms`` measured with CUDA events (the profiler's own host
    overhead is left out of both). Device activity only: ``device_groups``
    reads no host event, and host events cost the profiler's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reps = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            serving(batch)
        torch.cuda.synchronize()
    groups, count = device_groups(prof, reps)
    busy = sum(groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    prof_line = {
        "device_busy_ms_per_request": busy,
        "request_ms": request_ms,
        "idle_share": 1 - busy / request_ms if busy else None,
        "kernels_per_request": count,
        **kernel_shares(groups),
        "top_device_ms_per_request": {k[:80]: v for k, v in top},
    }
    log("profile: " + json.dumps(prof_line))
    return prof_line


# Device kernels of the port by name: (tag in the kernel's name, label);
# the first tag found names a kernel.
KERNEL_TAGS = (("BiasActEpi", "K1 gemm"),
               ("residual_layernorm", "K1 residual_layernorm"),
               ("window_attention_kernel", "K2 window_attention"),
               ("dense_attention", "K4 dense_attention"),
               ("gemm_kernel<(anonymous namespace)::Epi", "K3 gemm"),
               ("gemm_kernel<(anonymous namespace)::NormEpi", "K3 gemm"),
               ("gemm_kernel<(anonymous namespace)::FwdEpi", "K3 gemm"),
               ("gemm_f32_kernel", "K3 gemm"),
               ("measure_mma_kernel", "K3 attention"),
               ("measure_fma_kernel", "K3 attention"),
               ("select_kernel", "K3 attention"),
               ("attn_bwd_kernel", "K3 attention"),
               ("layernorm_bwd_kernel", "K3 rows"),
               ("to_bf16_kernel", "K3 rows"),
               ("::layernorm_kernel(", "K3 rows"),
               ("ReduceJobs", "K3 rows"))


def device_groups(prof, reps: int):
    """Device time (ms per rep) by kernel name from a torch.profiler run,
    the port's kernels under their labels (KERNEL_TAGS); and the device
    ops per rep. Annotations span ops counted already and are left out."""
    from torch.autograd import DeviceType

    groups, count = {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if (e.device_type != DeviceType.CUDA or t <= 0
                or getattr(e, "is_user_annotation", False)):
            continue  # device-side events only (CPU ops would count twice)
        name = next((label for tag, label in KERNEL_TAGS if tag in e.key), e.key)
        groups[name] = groups.get(name, 0.0) + t / reps / 1e3
        count += e.count
    return groups, count / reps


def kernel_shares(groups: dict) -> dict:
    """Each port kernel's share of device busy time, and the device time of
    PyTorch's same-type copies (``direct_copy_kernel``: a strided tensor
    made contiguous; type casts are other kernels)."""
    busy = sum(groups.values())
    shares = {}
    for name, t in groups.items():
        if name.startswith("K"):
            key = name.split()[0]
            shares[key] = shares.get(key, 0.0) + t / busy
    return {"kernel_share_of_busy": shares, "layout_copy_ms": sum(
        t for name, t in groups.items() if "direct_copy_kernel" in name)}


# --------------------------------------------------------------- phase 5b #


def k4_inputs(bh, l, e, e_v, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k = (torch.randn(bh, l, e, device="cuda", generator=g).to(dt) for _ in range(2))
    return q, k, torch.randn(bh, l, e_v, device="cuda", generator=g).to(dt)


def check_k4(results: dict) -> None:
    """K4 against its plain version (K4_CASES), then its gradient through
    the autograd Function against autograd of the plain version."""
    import torch

    from routeformer_torch.ops import flash_attention as fa

    worst = 0.0
    for bh, l, e, e_v, causal, dtype in K4_CASES:
        q, k, v = k4_inputs(bh, l, e, e_v, dtype, seed=l + e)
        scale = 1.0 / math.sqrt(e)
        before = fa.dense_launches
        got = fa.flash_attention_bhle(q, k, v, causal, scale)
        assert fa.dense_launches == before + 1, "K4 did not launch"
        want = fa.attention_bhle_plain(q, k, v, causal, scale)
        assert got.shape == want.shape and got.dtype == want.dtype
        err = rel_err(got, want)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        log(f"K4 {(bh, l, e, e_v)} causal={causal} {dtype}: "
            f"max|kernel-plain|/max|plain| = {err:.3e}")
        if not err <= K4_TOL:
            raise AssertionError(f"K4 disagrees with its plain version: {err} > {K4_TOL}")
        del q, k, v, got, want
    worst = max(worst, check_k4_views())
    results["k4_max_abs_err"] = worst

    q, k, v = k4_inputs(24, 600, 64, 64, "bfloat16", seed=5)
    weight = torch.randn(q.shape, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = fa.dense_launches
    out = fa.flash_attention_bhle(*leaves, True, 0.125)
    assert fa.dense_launches == before + 1, "K4 did not launch"
    got = torch.autograd.grad((out.float() * weight).sum(), leaves)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa.attention_bhle_plain(*(t.float() for t in leaves), True, 0.125).to(q.dtype)
    want = torch.autograd.grad((out.float() * weight).sum(), leaves)
    scale = max(t.float().abs().max().item() for t in want)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    log(f"K4 gradient, Function vs autograd of the plain version: "
        f"max|diff|/global max = {err / scale:.3e}")
    if not (scale > 0 and err <= K12_GRAD_TOL * scale):
        raise AssertionError(f"K4 gradient disagrees: {err / scale} > {K12_GRAD_TOL}")


def k4_views(b, l, h, e, seed):
    """q, k, v as the ViT hands them to ``dot_product_attention``: strided
    (B, L, H, E) views of one bf16 (B, L, 3, H, E) qkv buffer."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, l, 3, h, e, device="cuda", generator=g).bfloat16()
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def check_k4_views() -> float:
    """K4 on the ViT's views through ``dot_product_attention(impl="flash")``
    (K4_VIEW_CASES): one launch, one allocation (the output: no copy of q,
    k or v), and the plain version's result. Returns the worst max|diff|."""
    import torch

    from routeformer_torch.ops import attention
    from routeformer_torch.ops import flash_attention as fa

    worst = 0.0
    for b, l, h, e, causal in K4_VIEW_CASES:
        q, k, v = k4_views(b, l, h, e, seed=l)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        before = fa.dense_launches
        got = attention.dot_product_attention(q, k, v, causal=causal, impl="flash")
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
        assert fa.dense_launches == before + 1, "K4 did not launch"
        assert allocs == 1, f"K4 on views made {allocs} allocations, expected the output's only"
        want = fa.attention_bhle_plain(*(t.transpose(1, 2) for t in (q, k, v)), causal,
                                       e ** -0.5).transpose(1, 2)
        assert got.shape == want.shape == (b, l, h, e)
        err = rel_err(got, want)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        log(f"K4 views {(b, l, h, e)} causal={causal}: one launch, one allocation; "
            f"max|kernel-plain|/max|plain| = {err:.3e}")
        if not err <= K4_TOL:
            raise AssertionError(f"K4 on views disagrees with its plain version: {err} > {K4_TOL}")
        del q, k, v, got, want
    return worst


# --------------------------------------------------------------- phase 5c #


def serve_dinov2(results: dict) -> int:
    """The DinoV2 serving path with the plain Perceive layers; returns its
    K4 launches (counts set to 0 just before the four requests, read just
    after)."""
    import torch

    import routeformer_torch as rt

    set_fusion("0")
    t0 = time.perf_counter()
    model = rt.build_dinov2(seed=0)  # CUDA by default
    n_params = sum(p.numel() for p in model.parameters())
    rt.save_serving_bundle(BUNDLE_DIR, model)
    cfg = model.configs
    del model
    serving = rt.load_serving_bundle(BUNDLE_DIR)
    shutil.rmtree(BUNDLE_DIR)
    assert type(serving.model.video_backbone).__name__ == "DinoV2"
    log(f"DinoV2 model built, saved and reloaded: {n_params} parameters, "
        f"{time.perf_counter() - t0:.1f} s")
    requests = serving_requests(cfg)

    reset_counts()  # the main path: counts set to 0 just before, read just after
    expected = {"K1": 0, "K2": 0, "K3a": 0, "K3b": 0, "K4": K4_PER_FORWARD}
    for batch in requests:
        before = launch_counts()
        gps, dense = serving(batch)
        torch.cuda.synchronize()
        b = batch["gps"].shape[0]
        assert gps.shape == (b, cfg.gps_backbone_config.pred_len, 2), gps.shape
        assert dense.shape == (b, cfg.gps_backbone_config.pred_len,
                               cfg.image_embedding_size), dense.shape
        assert torch.isfinite(gps).all() and torch.isfinite(dense).all()
        per = {k: v - before[k] for k, v in launch_counts().items()}
        assert per == expected, f"launches per DinoV2 forward {per}, expected {expected}"
    launches = launch_counts()["K4"]
    log(f"DinoV2 served 3 x batch 1 and 1 x batch 4: shapes ok, finite, "
        f"{launches} K4 launches ({K4_PER_FORWARD} per forward), no K1/K2/K3a")
    out = results["dinov2"] = {"launches_per_forward": per}

    for b, batch in ((1, requests[0]), (4, requests[3])):
        torch.cuda.reset_peak_memory_stats()
        out[f"request_ms_b{b}"] = cuda_ms(lambda: serving(batch), iters=5, warmup=1)
        out[f"peak_gib_b{b}"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"DinoV2 request batch {b}: {out[f'request_ms_b{b}']:.2f} ms, "
            f"peak memory {out[f'peak_gib_b{b}']:.2f} GiB")
    out["profile"] = profile_request(serving, requests[0], out["request_ms_b1"])
    out["fused"] = fused = {}
    set_fusion("1")  # the same request through K3a: time and device time
    fused["request_ms_b1"] = cuda_ms(lambda: serving(requests[0]), iters=5, warmup=1)
    fused["profile"] = profile_request(serving, requests[0], fused["request_ms_b1"])
    set_fusion("0")
    out["card_vs_cpu"] = card_vs_cpu(serving, "norm", requests[0], depth=DINOV2_CPU_DEPTH)
    serve_dinov2_fused(serving, requests[0], fused)
    return launches


def serve_dinov2_fused(serving, batch, out: dict) -> None:
    """A batch-1 DinoV2 request with the fused Perceive stack (K3a, the frame
    encoder at 1370 tokens) against the plain-stack request, both
    exhaustive (the model is, after ``card_vs_cpu``): the frame encoder's
    output, the displacement and the dense features within FEATURE_TOL and
    PRED_TOL; 24 K3a launches per forward (counts set to 0 just before,
    read just after)."""
    import torch

    feats = {}

    def capture(_module, _inp, o):
        feats["frame"] = o.detach().float()

    hook = serving.model.frame_encoder.register_forward_hook(capture)
    set_fusion("0")
    gps_plain, dense_plain = serving(batch)
    frame_plain = feats["frame"]
    set_fusion("1")
    reset_counts()
    gps, dense = serving(batch)
    torch.cuda.synchronize()
    per = launch_counts()
    set_fusion("0")
    hook.remove()
    expected = {"K1": 0, "K2": 0, "K3a": K3A_PER_FORWARD, "K3b": 0, "K4": K4_PER_FORWARD}
    last = torch.as_tensor(batch["gps"][:, -1:], device=gps.device)
    errs = {"frame_encoder": rel_err(feats["frame"], frame_plain),
            "displacement": rel_err(gps - last, gps_plain - last),
            "dense": rel_err(dense, dense_plain)}
    log(f"DinoV2 request with the fused stack (exhaustive): launches {per}; fused vs plain "
        f"stack, max|diff|/max|plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert per == expected, f"launches per fused DinoV2 forward {per}, expected {expected}"
    assert errs["frame_encoder"] <= FEATURE_TOL, errs
    assert errs["displacement"] <= PRED_TOL and errs["dense"] <= PRED_TOL, errs
    assert torch.isfinite(gps).all() and torch.isfinite(dense).all()
    out.update(launches_per_forward=per, **errs)


# --------------------------------------------------------------- phase 5d #

EXPORT_TOL = 1e-3  # exported vs live prediction, of the max, where the bits differ
# The exported forwards (``serve.export_model``): the flagship with the fused
# Perceive stack (K1, K2, K3a) and DinoV2 with the plain layers (K4); the
# launches a batch-1 forward makes.
EXPORTS = (("flagship", "build_flagship", "1",
            {"K1": 24, "K2": 24, "K3a": K3A_PER_FORWARD, "K3b": 0, "K4": 0}),
           ("dinov2", "build_dinov2", "0",
            {"K1": 0, "K2": 0, "K3a": 0, "K3b": 0, "K4": K4_PER_FORWARD}))


def op_tape(fn, batch) -> list:
    """``fn(batch)`` with every call of a registered kernel op
    (``routeformer::*``) recorded: (op, its tensor inputs, its outputs)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Tape(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "routeformer":
                outs = out if isinstance(out, tuple) else (out,)
                self.calls.append((str(func), [a.clone() for a in args
                                               if isinstance(a, torch.Tensor)],
                                   [o.clone() for o in outs]))
            return out

    with torch.inference_mode(), Tape() as tape:
        fn(batch)
    return tape.calls


def module_outputs(model, batch) -> list:
    """The live model's module outputs (tensors) in the order they finish."""
    import torch

    outs = []

    def hook(name):
        def record(_module, _inp, out):
            out = out[0] if isinstance(out, tuple) else out
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                outs.append((name, out.detach().clone()))
        return record

    hooks = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    dev = next(model.parameters()).device
    with torch.inference_mode():
        model({k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    for h in hooks:
        h.remove()
    return outs


def node_outputs(exported, batch) -> list:
    """Every floating-point value the exported program's graph computes."""
    import torch
    from torch.fx import Interpreter

    vals = []

    class Record(Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                vals.append((n.name, str(n.target), out.clone()))
            return out

    with torch.inference_mode():
        Record(exported._program).run(exported._leaves, {
            k: torch.as_tensor(v, device=exported.device) for k, v in batch.items()})
    return vals


def name_export_difference(model, exported, batch) -> str:
    """Where the exported forward first parts from the live one: the first
    kernel op call whose outputs differ (with the same inputs, the op
    itself; else the plain ops before it); if every kernel op call agrees,
    the first module of the live model whose output no value of the
    exported graph reproduces bit for bit, with the closest graph node."""
    import torch

    dev = next(model.parameters()).device
    live = op_tape(lambda b: model({k: torch.as_tensor(v, device=dev)
                                    for k, v in b.items()}), batch)
    exp = op_tape(exported, batch)
    if [c[0] for c in live] != [c[0] for c in exp]:
        return f"the kernel op sequence differs: {len(live)} calls live, {len(exp)} exported"
    for i, (a, b) in enumerate(zip(live, exp)):
        if not all(torch.equal(x, y) for x, y in zip(a[2], b[2])):
            if all(torch.equal(x, y) for x, y in zip(a[1], b[1])):
                return f"{a[0]} (call {i}): the same inputs, different outputs"
            return f"the plain ops before {a[0]} (call {i}): its inputs differ"
    nodes = node_outputs(exported, batch)
    for name, out in module_outputs(model, batch):
        shaped = [(n, t, v) for n, t, v in nodes if v.shape == out.shape]
        if shaped and not any(torch.equal(v, out) for _, _, v in shaped):
            n, t, v = min(shaped, key=lambda x: (x[2].float() - out.float()).abs().max().item())
            err = (v.float() - out.float()).abs().max().item()
            return (f"module {name} (every kernel op call agrees); closest graph node "
                    f"{n} = {t}, max|diff| {err:.3e}")
    return "no module output differs"


def export_phase(results: dict, smi: str) -> dict:
    """Phase 5d: each model of EXPORTS exported from the card
    (``export_model``), reloaded from its bytes (``ExportedModel``) and the
    batch-1 request served through it and through the live model; the
    exported forward's launches (counts set to 0 just before, read just
    after) equal the live forward's, which equal the design's; the
    prediction the same bits, else within EXPORT_TOL of its max with the
    first differing op named; request ms (CUDA events) and device busy
    time of both routes; export and load seconds. Returns the launches of
    the exported forwards, per model."""
    import torch

    import routeformer_torch as rt
    from routeformer_torch.serve import ExportedModel, ServingModel, _eval_forward

    t_phase = time.perf_counter()
    out = results["export"] = {"card": smi}
    launches = {}
    for name, build, fusion, expected in EXPORTS:
        set_fusion(fusion)
        model = getattr(rt, build)(seed=0)
        live = ServingModel(model, torch.device("cuda"))
        batch = serving_requests(model.configs)[0]
        reset_counts()
        want = live(batch)[0]
        torch.cuda.synchronize()
        live_per = launch_counts()
        t0 = time.perf_counter()
        data = rt.export_model(model, batch)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exported = ExportedModel(data, _eval_forward(model)[1])
        load_s = time.perf_counter() - t0
        reset_counts()  # the exported path: counts set to 0 just before, read just after
        got = exported(batch)
        torch.cuda.synchronize()
        per = launch_counts()
        launches[name] = per
        same = torch.equal(got, want)
        err = rel_err(got, want)
        row = {"export_s": export_s, "load_s": load_s, "artifact_bytes": len(data),
               "launches_live": live_per, "launches_exported": per, "same_bits": same,
               "max_rel_err": err}
        if not same:
            row["first_difference"] = name_export_difference(model, exported, batch)
        for route, fn in (("live", lambda b: live(b)), ("exported", exported)):
            ms = cuda_ms(lambda: fn(batch), iters=5, warmup=1)
            prof = profile_request(fn, batch, ms)
            row[f"{route}_request_ms"] = ms
            row[f"{route}_device_busy_ms"] = prof["device_busy_ms_per_request"]
            row[f"{route}_kernels_per_request"] = prof["kernels_per_request"]
        out[name] = row
        log(f"{smi}: export {name}: {json.dumps(row)}")
        assert live_per == expected, f"{name}: live launches {live_per}, expected {expected}"
        assert per == live_per, f"{name}: exported launches {per}, live {live_per}"
        assert torch.isfinite(got).all() and got.shape == want.shape
        assert same or err <= EXPORT_TOL, row
        del model, live, exported, data, want, got
        free_device()
    set_fusion("0")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"export phase: {out['phase_s']:.1f} s")
    return launches


def serving_requests(cfg) -> list:
    """Three batch-1 and one batch-4 synthetic GEM-geometry requests."""
    from routeformer_torch.io.synthetic import synthetic_batch_numpy

    g = cfg.gps_backbone_config
    return [synthetic_batch_numpy(seed, b, seq_len=g.seq_len, pred_len=g.pred_len,
                                  fps=cfg.output_fps, with_video=True, with_gaze=True,
                                  frame_hw=(54, 96))["train"]
            for seed, b in ((1, 1), (2, 1), (3, 1), (4, 4))]


# ---------------------------------------------------------------- phase 6 #


def k3_inputs(r, l, seed, train):
    """Random stack weights at the flagship widths, rows ``(r, l, D)``,
    dropout keep-masks (train) and the eval key sample's counts."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    g = torch.Generator(device="cuda").manual_seed(seed)
    n, d, f = K3_N, K3_D, K3_F

    def rnd(*shape, s):
        return torch.randn(*shape, device="cuda", generator=g) * s

    w = fs.StackWeights(
        wq=rnd(n, d, d, s=d ** -0.5), bq=rnd(n, d, s=0.1),
        wk=rnd(n, d, d, s=d ** -0.5), bk=rnd(n, d, s=0.1),
        wv=rnd(n, d, d, s=d ** -0.5), bv=rnd(n, d, s=0.1),
        wout=rnd(n, d, d, s=d ** -0.5), bout=rnd(n, d, s=0.1),
        ln1_scale=1 + rnd(n, d, s=0.05), ln1_bias=rnd(n, d, s=0.05),
        wff1=rnd(n, d, f, s=d ** -0.5), bff1=rnd(n, f, s=0.1),
        wff2=rnd(n, f, d, s=f ** -0.5), bff2=rnd(n, d, s=0.1),
        ln2_scale=1 + rnd(n, d, s=0.05), ln2_bias=rnd(n, d, s=0.05),
    )
    x = rnd(r, l, d, s=1.0)
    masks = (fs.make_dropout_masks(n, r, l, d, f, K3_P, generator=g, device="cuda")
             if train else None)
    cnt = fs.sample_count_matrices(n, l, l, fs.prob_sparse_u(l, K3_FACTOR),
                                   device="cuda")
    return x, w, masks, cnt


def layer_of(stack, i):
    return None if stack is None else tuple(t[i] for t in stack)


def plain_measure(q, k, cnt, mm_dtype):
    """The sparsity measure ``max - sum / L`` of the plain version's q, k."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    qk = fs._mm(q, k.transpose(-1, -2), mm_dtype)
    sampled_max = torch.where(cnt > 0, qk, torch.full_like(qk, -1e30)).amax(-1)
    return sampled_max - (qk * cnt).sum(-1) / qk.shape[-1]


def selection_trace(x, w, cnt, masks, u, p, bf16: bool) -> dict:
    """The kernel's top-u selections against the plain version's, with the
    real u: "layer" runs each layer from the plain layer input (error on
    the tokens where no head's selection differs), "chain" runs the kernel
    and the plain stack each from its own previous layer (error on the rows
    where no selection differed in any layer; rows are independent).
    ``margin`` is the largest distance, over the selections that differ
    from equal inputs, of the plain measure from the other side of the
    top-u boundary, relative to the largest measure of its (row, head): an
    order that two sums may reverse is a near-tie."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    mm = torch.bfloat16 if bf16 else torch.float32
    kw = dict(heads=K3_H, u=u, dropout_rate=p, activation="gelu")
    r, l = x.shape[:2]
    out = {m: {"flips": 0, "margin": 0.0} for m in ("layer", "chain")}
    out["layer"]["err_clean_tokens"] = 0.0
    xc = {"kernel": x, "plain": x}
    rows_flipped = torch.zeros(r, dtype=torch.bool, device=x.device)
    for i in range(K3_N):
        wl, ml, c = layer_of(w, i), layer_of(masks, i), cnt[i].contiguous()
        y_p, inner = fs.layer_forward(xc["plain"], wl, c, ml, mm_dtype=mm,
                                      internals=True, **kw)
        q, k, _, _, chosen = inner["saved"]
        chosen = chosen[..., 0]
        m = plain_measure(q, k, c.float(), mm)
        s = m.sort(-1, descending=True).values
        gap = torch.where(chosen, m - s[..., u:u + 1], s[..., u - 1:u] - m)
        gap = gap / m.abs().amax(-1, keepdim=True)
        for mode in ("layer", "chain"):
            xk = xc["plain"] if mode == "layer" else xc["kernel"]
            sel = torch.empty(r, K3_H, l, dtype=torch.int8, device=x.device)
            y_k = fs.layer_forward_cuda(xk, wl, c, ml, compute_bf16=bf16, selection=sel, **kw)
            differ = sel.bool() != chosen
            o = out[mode]
            o["flips"] += int(differ.sum())
            # The margin of a flip from equal inputs: along the chain, only
            # in the rows whose earlier layers all selected alike.
            first = differ if mode == "layer" else differ & ~rows_flipped[:, None, None]
            if first.any():
                o["margin"] = max(o["margin"], gap[first].max().item())
            if mode == "layer":
                clean = ~differ.any(1)  # (R, L): no head's selection differs
                if clean.any():
                    err = (y_k - y_p).abs().amax(-1)[clean].max() / y_p.abs().max()
                    o["err_clean_tokens"] = max(o["err_clean_tokens"], err.item())
            else:
                rows_flipped |= differ.flatten(1).any(1)
                y_chain = y_k
        xc = {"kernel": y_chain, "plain": y_p}
    out["layer"]["of"] = K3_N * r * K3_H * l
    chain = out["chain"]
    chain["rows_flipped"] = int(rows_flipped.sum())
    yk, yp = xc["kernel"], xc["plain"]
    scale = yp.abs().max()
    chain["err"] = ((yk - yp).abs().max() / scale).item()
    clean = ~rows_flipped
    chain["err_clean_rows"] = (
        ((yk - yp)[clean].abs().max() / scale).item() if clean.any() else 0.0)
    return out


def check_k3a(results: dict) -> None:
    from routeformer_torch.ops import fusion_stack as fs

    worst = 0.0
    results["k3a_selections"] = traces = {}
    for name, r, l, _ in K3_GEOMS + K3_ZOO_GEOMS + [K3_DINO]:
        u = fs.prob_sparse_u(l, K3_FACTOR)
        for train in (False, True):
            x, w, masks, cnt = k3_inputs(r, l, seed=r * l + train, train=train)
            p = K3_P if train else 0.0
            mode = "train" if train else "eval"
            for label, bf16, factor in (("bf16 u=L", True, 10 ** 6),
                                        (f"f32 u={u}", False, K3_FACTOR)):
                got = fs.fused_perceive_stack(x, w, cnt, masks, heads=K3_H, factor=factor,
                                              dropout_rate=p, compute_bf16=bf16)
                want = fs.stack_reference(x, w, cnt, masks, heads=K3_H,
                                          u=fs.prob_sparse_u(l, factor),
                                          dropout_rate=p, compute_bf16=bf16)
                err = rel_err(got, want)
                worst = max(worst, (got - want).abs().max().item())
                log(f"K3a {name} ({r}, {l}) {mode} {label}, {K3_N} layers: "
                    f"max|kernel-plain|/max|plain| = {err:.3e}")
                if not err <= K3A_TOL:
                    raise AssertionError(f"K3a disagrees with its plain version: {err} > {K3A_TOL}")
            for prec in ("f32", "bf16"):
                t = selection_trace(x, w, cnt, masks, u, p, bf16=prec == "bf16")
                traces[f"{name} {mode} {prec}"] = t
                log(f"K3a {name} ({r}, {l}) {mode} {prec} u={u}, selections: "
                    + json.dumps(t))
                fine = max(t["layer"]["err_clean_tokens"], t["chain"]["err_clean_rows"])
                if prec == "f32":  # f32: a selection may differ only at a near-tie
                    near = max(t["layer"]["margin"], t["chain"]["margin"])
                    ok = fine <= K3A_F32_CLEAN_TOL and near <= K3A_F32_TIE
                else:
                    # bf16: the two chains' inputs part by bf16 roundings from
                    # the first layer on, so only the layer mode compares the
                    # measure on equal inputs.
                    ok = fine <= K3A_BF16_CLEAN_TOL and t["layer"]["margin"] <= K3A_BF16_TIE
                if not ok:
                    raise AssertionError(f"K3a {prec} selections: {t}")
    results["k3a_max_abs_err"] = worst


def check_k3a_measure(results: dict) -> None:
    """bf16 with the real u at every K3a geometry, eval and train: the
    selection of the tensor-core measure (``measure_mma_kernel``) against
    the rank test ``#{j : m_j > m_i} < u`` of the measure rebuilt in f64
    from the q|k the kernel stored (bf16, so the products are exact) and
    the counts. Only the order of the kernel's f32 sums differs: a
    selection may differ only within K3A_F32_TIE of the max measure of the
    boundary."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    out = {}
    for name, r, l, _ in K3_GEOMS + K3_ZOO_GEOMS + [K3_DINO]:
        u = fs.prob_sparse_u(l, K3_FACTOR)
        for train in (False, True):
            x, w, masks, cnt = k3_inputs(r, l, seed=r * l + 13 + train, train=train)
            p = K3_P if train else 0.0
            sel = torch.empty(r, K3_H, l, dtype=torch.int8, device="cuda")
            fs.layer_forward_cuda(x, layer_of(w, 0), cnt[0].contiguous(), layer_of(masks, 0),
                                  heads=K3_H, u=u, dropout_rate=p, activation="gelu",
                                  compute_bf16=True, selection=sel)
            torch.cuda.synchronize()
            m, d = r * l, K3_D
            qk = fs._workspaces[x.device][:m * d].view(torch.bfloat16).view(r, l, 2, K3_H, -1)
            c = cnt[0].double()
            flips, margin = 0, 0.0
            for h in range(K3_H):
                q, k = qk[:, :, 0, h].double(), qk[:, :, 1, h].double()
                s = q @ k.transpose(-1, -2)
                top = torch.where(c > 0, s, torch.full_like(s, -torch.inf)).amax(-1)
                meas = top - (s * c).sum(-1) / l
                s = meas.sort(-1, descending=True).values
                want = meas >= s[:, u - 1:u]
                gap = torch.where(want, meas - s[:, u:u + 1], s[:, u - 1:u] - meas)
                differ = sel[:, h].bool() != want
                flips += int(differ.sum())
                if differ.any():
                    rel = gap / meas.abs().amax(-1, keepdim=True)
                    margin = max(margin, rel[differ].max().item())
            key = f"{name} {'train' if train else 'eval'}"
            out[key] = {"flips": flips, "margin": margin, "of": r * K3_H * l}
            log(f"K3a {name} ({r}, {l}) {key.split()[-1]} bf16 u={u}: tensor-core selection "
                f"vs the rank test of its stored q|k: " + json.dumps(out[key]))
            if margin > K3A_F32_TIE or int(sel.sum(-1).min()) < u:
                raise AssertionError(f"K3a's measure disagrees with its stored q|k: {out[key]}")
            del x, w, masks, cnt, qk
            torch.cuda.empty_cache()
    results["k3a_measure_flips"] = {k: v["flips"] for k, v in out.items()}


def check_k3b(results: dict) -> None:
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    worst = 0.0
    for name, r, l, _ in K3_GEOMS + K3_ZOO_GEOMS:
        u = fs.prob_sparse_u(l, K3_FACTOR)
        x, w, masks, cnt = k3_inputs(r, l, seed=r * l + 7, train=True)
        g = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(r * l))
        wl, ml, c = layer_of(w, 0), layer_of(masks, 0), cnt[0].contiguous()
        for label, bf16, uu in (("bf16 u=L", True, l), (f"f32 u={u}", False, u)):
            kw = dict(heads=K3_H, u=uu, dropout_rate=K3_P, activation="gelu")
            dx_k, dw_k = fs.layer_backward_cuda(x, g, wl, c, ml, compute_bf16=bf16, **kw)
            dx_p, dw_p = fs.layer_backward(
                x, g, wl, c, ml, mm_dtype=torch.bfloat16 if bf16 else torch.float32, **kw)
            err_dx = rel_err(dx_k, dx_p)
            scale = max(t.abs().max().item() for t in dw_p)
            diff_w = max((a - b).abs().max().item() for a, b in zip(dw_k, dw_p))
            worst = max(worst, (dx_k - dx_p).abs().max().item(), diff_w)
            log(f"K3b {name} ({r}, {l}) train {label}: dx max|kernel-plain|/max|plain| = "
                f"{err_dx:.3e}; weight grads max|kernel-plain|/global max = "
                f"{diff_w / scale:.3e}")
            if not (err_dx <= K3B_TOL and diff_w <= K3B_TOL * scale):
                raise AssertionError(f"K3b disagrees with the plain backward: "
                                     f"{err_dx}, {diff_w / scale} > {K3B_TOL}")
    results["k3b_max_abs_err"] = worst


def check_k3b_selection(results: dict) -> None:
    """With the real u at every backward geometry, in the precision its
    stack runs (bf16; f32 for ``K3_F32``), eval and train: the selection
    K3b's recompute made and differentiated against K3a's on the same layer
    input, through the 8 layers of a stack (each layer's input the previous
    K3a output). Any flip fails."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    flips = {}
    for name, r, l, _ in K3_BACKWARD_GEOMS:
        u = fs.prob_sparse_u(l, K3_FACTOR)
        bf16 = name not in K3_F32
        for train in (False, True):
            x, w, masks, cnt = k3_inputs(r, l, seed=r * l + 11 + train, train=train)
            p = K3_P if train else 0.0
            kw = dict(heads=K3_H, u=u, dropout_rate=p, activation="gelu", compute_bf16=bf16)
            fwd = torch.empty(r, K3_H, l, dtype=torch.int8, device="cuda")
            bwd = torch.empty_like(fwd)
            n = 0
            for i in range(K3_N):
                wl, ml, c = layer_of(w, i), layer_of(masks, i), cnt[i].contiguous()
                y = fs.layer_forward_cuda(x, wl, c, ml, selection=fwd, **kw)
                fs.layer_backward_cuda(x, torch.ones_like(x), wl, c, ml, selection=bwd, **kw)
                n += int((fwd != bwd).sum())
                x = y
            key = f"{name} {'train' if train else 'eval'}"
            flips[key] = n
            log(f"K3b vs K3a selections, {name} ({r}, {l}) {key.split()[-1]} "
                f"{'bf16' if bf16 else 'f32'} u={u}, "
                f"{K3_N} layers: {n} flips of {K3_N * r * K3_H * l}")
    results["k3b_selection_flips"] = flips
    if any(flips.values()):
        raise AssertionError(f"K3b differentiated another selection than K3a made: {flips}")


def check_k3b_determinism(results: dict) -> None:
    """K3b twice on the same inputs at every backward geometry, in the
    precision its stack runs: the same bits in dx and in all 16 weight
    grads (fixed-order sums, no atomics)."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    for name, r, l, _ in K3_BACKWARD_GEOMS:
        x, w, masks, cnt = k3_inputs(r, l, seed=r * l + 9, train=True)
        g = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(l))
        kw = dict(heads=K3_H, u=fs.prob_sparse_u(l, K3_FACTOR), dropout_rate=K3_P,
                  activation="gelu", compute_bf16=name not in K3_F32)
        args = (x, g, layer_of(w, 0), cnt[0].contiguous(), layer_of(masks, 0))
        dx1, dw1 = fs.layer_backward_cuda(*args, **kw)
        dx2, dw2 = fs.layer_backward_cuda(*args, **kw)
        same = torch.equal(dx1, dx2) and all(torch.equal(a, b) for a, b in zip(dw1, dw2))
        log(f"K3b {name} ({r}, {l}) twice on the same inputs: "
            f"{'bit-identical' if same else 'DIFFERENT'} dx and weight grads")
        if not same:
            raise AssertionError(f"K3b is not deterministic at {name}")
    results["k3b_deterministic"] = True


def check_k12_grad(results: dict) -> None:
    """At the stage-3 geometry: gradients through the K1/K2 autograd
    Functions (kernel forward) against autograd of the plain versions
    (the Functions' backward recomputes the plain version in f32)."""
    import torch

    from routeformer_torch.ops import flash_attention as fa
    from routeformer_torch.ops import swin_block_fusion as sbf

    def grads(fn, leaves, weight):
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * weight).sum(), leaves)

    def compare(name, got, want):
        scale = max(t.float().abs().max().item() for t in want)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        log(f"{name} gradient, Function vs autograd of the plain version: "
            f"max|diff|/global max = {err / scale:.3e}")
        if not (scale > 0 and err <= K12_GRAD_TOL * scale):
            raise AssertionError(f"{name} gradient disagrees: {err / scale} > {K12_GRAD_TOL}")

    _, b, n, c, h, _, _ = STAGES[3]
    q, k, v, bias, scale = k2_inputs(b, h, n, c // h, 1, seed=3)
    weight = torch.randn(q.shape, device="cuda")
    before = fa.launches
    got = grads(lambda *t: fa.flash_window_attention(*t, cosine=True),
                (q, k, v, bias, scale), weight)
    assert fa.launches == before + 1, "K2 did not launch"
    want = grads(lambda q_, k_, v_, b_, s_: fa.flash_window_attention_plain(
        q_.float(), k_.float(), v_.float(), b_, s_, True).to(v_.dtype),
        (q, k, v, bias, scale), weight)
    compare("K2", got, want)

    x, params, bias = k1_inputs(b, n, c, h, None, seed=4)
    keys = sbf.PARAM_KEYS
    weight = torch.randn(x.shape, device="cuda")
    before = sbf.launches
    got = grads(lambda x_, b_, *p: sbf.fused_swin_block(x_, dict(zip(keys, p)), b_, h, True),
                (x, bias, *(params[k] for k in keys)), weight)
    assert sbf.launches == before + 1, "K1 did not launch"
    want = grads(lambda x_, b_, *p: sbf.fused_swin_block_plain(
        x_, dict(zip(keys, p)), b_, h, compute_bf16=False),
        (x, bias, *(params[k] for k in keys)), weight)
    compare("K1", got, want)


# ---------------------------------------------------------------- phase 7 #


def launch_counts() -> dict:
    from routeformer_torch.ops import flash_attention as fa
    from routeformer_torch.ops import fusion_stack as fs
    from routeformer_torch.ops import swin_block_fusion as sbf

    return {"K1": sbf.launches, "K2": fa.launches, "K3a": fs.launches_fwd,
            "K3b": fs.launches_bwd, "K4": fa.dense_launches}


def reset_counts() -> None:
    from routeformer_torch.ops import flash_attention as fa
    from routeformer_torch.ops import fusion_stack as fs
    from routeformer_torch.ops import swin_block_fusion as sbf

    sbf.launches = fa.launches = fs.launches_fwd = fs.launches_bwd = fa.dense_launches = 0


def train_batches(seed: int):
    import routeformer_torch as rt

    cfg = rt.flagship_config()
    g = cfg.gps_backbone_config
    data = rt.synthetic_batch(seed, TRAIN_BATCH, seq_len=g.seq_len, pred_len=g.pred_len,
                              fps=cfg.output_fps, with_video=True, with_gaze=True,
                              frame_hw=(54, 96))
    return data["train"], data["target"]


def set_fusion(mode: str) -> None:
    os.environ["ROUTEFORMER_FUSION_KERNEL"] = mode


def train_flagship(results: dict) -> dict:
    """The main path of this slice: flagship train steps with the fused
    Perceive stacks. Returns the launches of its two checked steps."""
    import torch

    import routeformer_torch as rt

    set_fusion("1")
    model, optimizer, step = rt.build_flagship_training(seed=0)
    optimizer.count = TRAIN_EPOCH  # one update per epoch so far: the lr is past warmup
    inp, tgt = train_batches(21)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    reset_counts()  # the main path: counts set to 0 just before, read just after
    metrics, per_step = [], []
    for _ in range(2):
        counts = launch_counts()
        metrics.append(step(inp, tgt, TRAIN_EPOCH))
        torch.cuda.synchronize()
        per_step.append({k: v - counts[k] for k, v in launch_counts().items()})
    launches = launch_counts()
    results["train_launches_per_step"] = per_step
    log(f"flagship train, 2 steps at batch {TRAIN_BATCH}: launches per step {per_step}")
    for counts in per_step:
        assert all(counts[k] in PER_STEP[k] for k in PER_STEP), (
            f"launches {counts}, expected {PER_STEP}")
    for m in metrics:
        values = {k: v.item() for k, v in m.items()}
        log(f"step metrics: {values}")
        assert all(math.isfinite(v) for v in values.values()), values
    moved = {"backbone": 0.0, "rest": 0.0}
    for n, p in model.named_parameters():
        key = "backbone" if "video_backbone" in n else "rest"
        moved[key] = max(moved[key], (p.detach() - before[n]).abs().max().item())
    log(f"largest parameter change after 2 steps: {moved}")
    assert moved["rest"] > 0.0, "the trained parameters did not move"
    assert moved["backbone"] < 1e-7, "the frozen backbone moved"
    del before

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(inp, tgt, TRAIN_EPOCH), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    set_fusion("0")
    plain_ms = cuda_ms(lambda: step(inp, tgt, TRAIN_EPOCH), iters=3, warmup=1)
    set_fusion("1")
    log(f"train step batch {TRAIN_BATCH}: {step_ms:.2f} ms with K3a/K3b, "
        f"{plain_ms:.2f} ms with the plain stack; peak memory {peak:.2f} GiB")
    results.update(train_step_ms=step_ms, train_step_plain_stack_ms=plain_ms,
                   train_peak_gib=peak)
    profile_step(lambda: step(inp, tgt, TRAIN_EPOCH), step_ms, results)
    return launches


def profile_step(run, step_ms: float, results: dict, key: str = "train_profile") -> dict:
    """Device time by kernel over one train step (torch.profiler, device
    activity only, as ``profile_request``) and the device's idle share of
    the step time measured with CUDA events, kept under ``results[key]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups, count = device_groups(prof, 1)
    busy = sum(groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:12]
    line = {
        "device_busy_ms_per_step": busy,
        "step_ms": step_ms,
        "idle_share": 1 - busy / step_ms if busy else None,
        "kernels_per_step": count,
        **kernel_shares(groups),
        "top_device_ms_per_step": {k[:80]: v for k, v in top},
    }
    results[key] = line
    log(f"{key}: " + json.dumps(line))
    return line


def quiet(model) -> None:
    """Every dropout rate 0, no motion noise, exhaustive ProbSparse."""
    import torch

    from routeformer_torch.models.cross_modal import PerceiveEncoder
    from routeformer_torch.models.layers.attention import FullAttention

    cfg = model.configs
    cfg.view_dropout = cfg.gaze_dropout = cfg.motion_noise = 0.0
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, PerceiveEncoder):
            m.dropout_rate = 0.0
        elif isinstance(m, FullAttention):
            m.attention_dropout = 0.0
    set_exhaustive(model)


def rounded_linear(lin, round_out: bool, x):
    """``lin(x)`` at the fused stack's rounding points: bf16 operands with
    f32 accumulation and an f32 output, forward and backward (dX and dW
    from bf16 operands, f32 out); ``round_out`` rounds the output to bf16,
    as the fused stack rounds q and k for the scores."""
    import torch

    class Rounded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            xb, wb = x.bfloat16().float(), w.bfloat16().float()
            ctx.save_for_backward(xb, wb)
            return xb @ wb.t() + b

        @staticmethod
        def backward(ctx, g):
            xb, wb = ctx.saved_tensors
            gb = g.bfloat16().float()
            gw = gb.reshape(-1, gb.shape[-1]).t() @ xb.reshape(-1, xb.shape[-1])
            return gb @ wb, gw, g.reshape(-1, g.shape[-1]).sum(0)

    y = Rounded.apply(x, lin.weight, lin.bias)
    return y.bfloat16() if round_out else y


def set_stacks(model, mode: str) -> None:
    """How the Perceive encoders compute. "bf16": the flagship's (the plain
    layers' Linear outputs are bf16); "f32out": the plain layers round as
    the fused stack does (``rounded_linear``); "f32": everything in f32.
    The fused stack reads only ``compute_bf16`` (bf16 in the first two)."""
    import functools

    import torch

    from routeformer_torch.models.cross_modal import PerceiveEncoder
    from routeformer_torch.models.layers.attention import Linear

    for enc in model.modules():
        if not isinstance(enc, PerceiveEncoder):
            continue
        enc.compute_bf16 = mode != "f32"
        for name, lin in enc.stacked_layers.named_modules():
            if isinstance(lin, Linear):
                lin.__dict__.pop("forward", None)
                lin.compute_dtype = None if mode == "f32" else torch.bfloat16
                if mode == "f32out":
                    qk = name.endswith(("query_projection", "key_projection"))
                    lin.forward = functools.partial(rounded_linear, lin, qk)


def perturb_perceive(model, eps: float) -> list:
    """Scale every Perceive encoder output by ``1 + eps * n`` (n standard
    normal, drawn from a fixed seed): the plain step's own sensitivity to a
    rounding-sized change of what the encoders hand on. Returns the hooks."""
    import torch

    from routeformer_torch.models.cross_modal import PerceiveEncoder

    def hook(_module, _inp, out):
        g = torch.Generator(device=out.device).manual_seed(0)
        return out * (1 + eps * torch.randn(out.shape, generator=g, device=out.device))

    return [m.register_forward_hook(hook) for m in model.modules()
            if isinstance(m, PerceiveEncoder)]


def parity_step(model, optimizer, step, state, batch, fusion: str, stacks: str,
                eps: float = 0.0) -> dict:
    """One train step from ``state`` and a fresh optimizer state."""
    set_fusion(fusion)
    set_stacks(model, stacks)
    hooks = perturb_perceive(model, eps) if eps else []
    model.load_state_dict(state)
    optimizer.opt.state.clear()
    optimizer.count = TRAIN_EPOCH
    metrics = step(*batch, TRAIN_EPOCH)
    for h in hooks:
        h.remove()
    return {
        "loss": metrics["total_loss"].item(),
        "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
        "update": {n: p.detach() - state[n] for n, p in model.named_parameters()},
        "lr": optimizer.opt.param_groups[0]["lr"],
    }


def step_gap(k: dict, p: dict) -> dict:
    """Step ``k`` against step ``p``. Adam's first update is about
    lr * sign(g): an element whose gradient is near 0 may take the other
    sign; one with |g| > 0.1 of the largest must take the same step."""
    gscale = max(g.abs().max().item() for g in p["grads"].values())
    gdiff = {n: (k["grads"][n] - g).abs().max().item() for n, g in p["grads"].items()}
    lr = p["lr"]
    differs, elements, firm_err = 0, 0, 0.0
    for n, u in p["update"].items():
        diff = (k["update"][n] - u).abs()
        differs += int((diff > 0.1 * lr).sum())
        elements += diff.numel()
        firm = p["grads"][n].abs() > 2 * STEP_GRAD_TOL * gscale
        if firm.any():
            firm_err = max(firm_err, diff[firm].max().item())
    return {"loss_rel": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
            "grad_rel": max(gdiff.values()) / gscale,
            "grad_worst": sorted(gdiff, key=gdiff.get, reverse=True)[:2],
            "update_share_differs": differs / elements, "firm_update_lr": firm_err / lr}


# The step comparisons: (kernel or first step, plain step) as (fusion,
# stacks, eps). The last two are the plain bf16 step against itself with
# the Perceive outputs perturbed at half a bf16 ulp and at one f32 ulp.
PARITY_PAIRS = {
    "bf16": (("1", "bf16", 0.0), ("0", "bf16", 0.0)),
    "f32out": (("1", "bf16", 0.0), ("0", "f32out", 0.0)),
    "f32": (("1", "f32", 0.0), ("0", "f32", 0.0)),
    "plain 2^-9": (("0", "bf16", 2.0 ** -9), ("0", "bf16", 0.0)),
    "plain 2^-23": (("0", "bf16", 2.0 ** -23), ("0", "bf16", 0.0)),
}


def train_parity(results: dict) -> None:
    """Kernel steps against plain-stack steps from the same weights and
    batch, dropout off and exhaustive ProbSparse, over ``PARITY_SEEDS``
    batches (``PARITY_PAIRS``, limits ``STEP_TOLS``)."""
    import torch

    import routeformer_torch as rt

    model, optimizer, step = rt.build_flagship_training(seed=0)
    quiet(model)
    state = {n: t.clone() for n, t in model.state_dict().items()}
    results["train_parity"] = gaps = {}
    for seed in PARITY_SEEDS:
        batch = train_batches(seed)
        runs = {}
        for label, pair in PARITY_PAIRS.items():
            for spec in pair:
                if spec not in runs:
                    runs[spec] = parity_step(model, optimizer, step, state, batch, *spec)
            gap = gaps.setdefault(label, {})[seed] = step_gap(*(runs[s] for s in pair))
            log(f"step gap, batch seed {seed}, {label}: " + json.dumps(gap))
        del runs
        for label, tol in STEP_TOLS.items():
            gap = gaps[label][seed]
            if not (gap["loss_rel"] <= STEP_LOSS_TOL and gap["grad_rel"] <= tol
                    and gap["firm_update_lr"] <= 0.1
                    and gap["update_share_differs"] <= STEP_UPDATE_SHARE):
                raise AssertionError(f"kernel step vs plain-stack step ({label}, batch "
                                     f"seed {seed}): {gap}, gradient limit {tol}")
    set_stacks(model, "bf16")
    set_fusion("1")
    del model, optimizer, step, state
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 7b #

# The training run: the driver's trainer, data and checkpoints at batch 16
# (GEM geometry, the flagship at full width), 3 train batches and 1 val
# batch per epoch.
RUN_DIR = ROOT / "build" / "smoke_run"
# One cold epoch (two gave the same checks; cut for the smoke's time).
RUN_ENV = {"DATASET": "GEM", "MODEL_SET": "flagship", "BATCH_SIZE": str(TRAIN_BATCH),
           "EPOCHS": "1", "SAVE_EVERY_STEPS": "1"}
RUN_TRAIN, RUN_VAL = 3, 1
# The driver's flagship takes the JAX driver's exact-gelu SwinV2, whose
# blocks run the unfused block: K2 in each of the 24 blocks, no K1. A cold
# step runs two backbone passes (the input and the target pass, 48 K2) and
# 6 Perceive stacks (48 K3a); an eval forward at batch 16 (the MC eval
# runs 5 a batch) one backbone pass and 3 stacks.
RUN_PER_STEP = {"K1": 0, "K2": 48, "K3a": 48, "K4": 0}
PER_EVAL_FORWARD = {"K1": 0, "K2": 24, "K3a": 24, "K3b": 0, "K4": 0}
MC_SAMPLES = 5
MEMO_TOL = 1e-2  # memo features vs the backbone's, of max (bf16 store)
STEADY_LOSS_TOL = 1e-2  # steady vs cold loss, relative (bf16 features)


def reset_peak() -> None:
    import torch

    torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30


def run_setup(dev, env=None, fresh: bool = True, n_train: int = RUN_TRAIN):
    """The driver's settings and data for the run (``n_train`` and
    ``RUN_VAL`` batches) and, with ``fresh``, a fresh results directory."""
    from routeformer_torch.experiments import full_comparison as fc

    s = fc.Settings.from_env(dict(RUN_ENV, RESULTS_DIR=str(RUN_DIR), **(env or {})))
    if fresh:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    train, val = fc.build_data(s)
    return s, [train[i] for i in range(n_train)], [val[i] for i in range(RUN_VAL)]


def step_launches(fn) -> dict:
    import torch

    before = launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in launch_counts().items()}


def params_of(models) -> dict:
    return {n: p.detach().clone() for n, p in models.named_parameters()}


def first_difference(got: dict, want: dict):
    """The first tensor (in module order) whose bits differ, or None."""
    import torch

    return next((n for n in want if not torch.equal(got[n], want[n])), None)


def name_nondeterminism(run) -> dict:
    """``run()`` repeats a comparison and returns whether its bits matched.
    First with cuDNN held to deterministic algorithms: if the bits then
    match, the op is cuDNN's convolution backward. Else under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    warns for each op without a deterministic CUDA implementation."""
    import warnings

    import torch

    torch.backends.cudnn.deterministic = True
    try:
        if run():
            return {"op": "cuDNN convolution backward (the same bits with "
                          "torch.backends.cudnn.deterministic = True)", "same_bits": True}
    finally:
        torch.backends.cudnn.deterministic = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            bits = run()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:200] for w in caught
                  if "deterministic" in str(w.message)})
    return {"op": ops or "not named: no op warned", "same_bits": bits}


def trainer_vs_step(results: dict, dev) -> None:
    """A ``ParallelTrainer`` holding the flagship alone against
    ``build_flagship_training``'s step: the same seed weights, batches and
    generator seeds, dropout off, exhaustive ProbSparse, two steps past the
    warmup. The same bits; else the first step (both from the same
    weights) within phase 7's kernel-step limits, the first differing
    tensor and the nondeterministic op named, and the two steps again with
    that op held deterministic: the same bits. (The second step's gap is
    reported, not limited: after one step the weights differ where AdamW
    moved near-zero gradients by lr x their sign.)"""
    import torch

    import routeformer_torch as rt
    from routeformer_torch.optimizers import build_optimizer
    from routeformer_torch.train import ParallelTrainer

    model, optimizer, step = rt.build_flagship_training(seed=0, device=dev)
    mine = rt.build_flagship(seed=0, device=dev)
    quiet(model)
    quiet(mine)
    trainer = ParallelTrainer(
        {"flagship": mine},
        lambda m: build_optimizer(m, learning_rate=1e-5, weight_decay=1e-4,
                                  video_backbone_lr=1e-6, warmup_epochs=2, max_epochs=200,
                                  gradient_clip_val=2.5),
        mine.configs, unfreeze_epoch=None, device=dev)
    trainer.epoch = TRAIN_EPOCH
    state_a, state_b = params_of(model), params_of(mine)
    report = {"steps": []}

    def run_pair(seeds):
        model.load_state_dict(state_a, strict=False)
        mine.load_state_dict(state_b, strict=False)
        for opt in (optimizer, trainer.optimizer):
            opt.opt.state.clear()
            opt.count = TRAIN_EPOCH
        out = []
        for seed in seeds:
            inp, tgt = train_batches(seed)
            torch.manual_seed(seed)
            want = step(inp, tgt, TRAIN_EPOCH)["total_loss"]
            torch.manual_seed(seed)
            got = trainer.training_step({"train": inp, "target": tgt})["train_total_loss"]
            want_g = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            got_g = {n.split(".", 1)[1]: p.grad for n, p in trainer.models.named_parameters()}
            gscale = max(g.abs().max().item() for g in want_g.values())
            out.append({"loss": got.item(), "want_loss": want.item(),
                        "loss_bits": bool(torch.equal(got, want)),
                        "grad_rel": max((got_g[n] - g).abs().max().item()
                                        for n, g in want_g.items()) / gscale,
                        "first_grad_diff": first_difference(got_g, want_g),
                        "first_param_diff": first_difference(
                            {n.split(".", 1)[1]: p.detach()
                             for n, p in trainer.models.named_parameters()},
                            {n: p.detach() for n, p in model.named_parameters()})})
        return out

    def same_bits(steps) -> bool:
        return all(s_["loss_bits"] and s_["first_param_diff"] is None for s_ in steps)

    seeds = (31, 32)
    report["steps"] = steps = run_pair(seeds)
    report["same_bits"] = same_bits(steps)
    if not report["same_bits"]:
        first = steps[0]
        assert (abs(first["loss"] - first["want_loss"]) <= STEP_LOSS_TOL * abs(first["want_loss"])
                and first["grad_rel"] <= STEP_TOLS["bf16"]), report
        report["nondeterminism"] = name_nondeterminism(lambda: same_bits(run_pair(seeds)))
        assert report["nondeterminism"]["same_bits"], report
    results["trainer_vs_step"] = report
    log("trainer vs build_flagship_training's step: " + json.dumps(report))
    del model, optimizer, step, mine, trainer, state_a, state_b
    free_device()


def cold_epochs(results: dict, dev, smi: str):
    """The main path of this slice: a cold epoch through the driver's
    ``run_epochs`` (the backbone in every step, the MC eval, ``maybe_save``,
    ``save_latest`` after every step), the launches counted from 0 just
    before and read just after. Then the cold step's and the MC eval's
    times. Returns the trainer, its checkpoint manager and the data."""
    import torch

    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.train import CheckpointManager, MetricsLogger

    set_fusion("1")
    s, train, val = run_setup(dev)
    trainer = fc.build_trainer(s, fc.build_models(s), dev)
    ckpt = CheckpointManager(s.results_dir / "checkpoints")
    metrics_logger = MetricsLogger(s.results_dir / "logs", experiment="smoke_run")
    saves = []
    save_latest = ckpt.save_latest

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save_latest(*args, **kwargs)
        saves.append(time.perf_counter() - t0)

    ckpt.save_latest = timed_save
    reset_peak()
    reset_counts()  # the main path: counts set to 0 just before, read just after
    history = fc.run_epochs(trainer, ckpt, metrics_logger, train, val, lambda b: b,
                            epochs=s.epochs, save_every=s.save_every_steps)
    torch.cuda.synchronize()
    launches = launch_counts()
    run_peak = peak_gib()
    metrics_logger.close()
    ckpt.save_latest = save_latest
    steps, evals = s.epochs * RUN_TRAIN, s.epochs * RUN_VAL * MC_SAMPLES
    if dev.type == "cuda":
        for k in ("K1", "K2", "K3a", "K4"):
            want = steps * RUN_PER_STEP[k] + evals * PER_EVAL_FORWARD[k]
            assert launches[k] == want, f"cold epochs: {k} {launches[k]} launches, not {want}"
        assert steps * 16 <= launches["K3b"] <= steps * 24, launches
    for h in history:
        values = [float(v) for v in h["val"].values()]
        assert all(math.isfinite(v) for v in values), h
    assert set(ckpt.best) == {fc.FLAGSHIP}
    assert (s.results_dir / "checkpoints" / "_latest" / "position.json").exists()

    b0 = train[0]
    per_step = step_launches(lambda: trainer.training_step(b0))
    reset_peak()
    step_ms = cuda_ms(lambda: trainer.training_step(b0), iters=3, warmup=1)
    step_peak = peak_gib()
    profile = profile_step(lambda: trainer.training_step(b0), step_ms, results,
                           key="run_cold_profile")
    reset_peak()
    eval_ms = cuda_ms(lambda: trainer.eval_batch_raw(val[0]), iters=2, warmup=1)
    eval_peak = peak_gib()
    out = {
        "epochs": [{"epoch": h["epoch"], "seconds": h["seconds"],
                    "val_ade": float(h["val"][f"val_{fc.FLAGSHIP}_ade"])} for h in history],
        "launches": launches, "run_peak_gib": run_peak,
        "save_latest_s": saves, "best": ckpt.best,
        "cold_step_ms": step_ms, "cold_step_peak_gib": step_peak,
        "cold_step_device_busy_ms": profile["device_busy_ms_per_step"],
        "cold_step_idle_share": profile["idle_share"],
        "cold_launches_per_step": per_step,
        "mc_eval_ms_per_batch": eval_ms, "mc_eval_peak_gib": eval_peak,
    }
    results["run_cold"] = out
    log(f"{smi}: cold epochs {json.dumps(out)}")
    return trainer, ckpt, s, train, val


def resume_check(results: dict, dev, smi: str, trainer, ckpt, s, train,
                 key: str = "run_resume") -> None:
    """Snapshot after a step mid-epoch, take the next step; a fresh trainer
    restores the snapshot and takes the same step: its loss and parameters
    against the uninterrupted run's, bit for bit; else the loss within
    phase 7's limit, the nondeterministic op named, and two restores of the
    snapshot with that op held deterministic: the same bits."""
    import torch

    from routeformer_torch.experiments import full_comparison as fc

    trainer.epoch = 2
    trainer.training_step(train[0])
    t0 = time.perf_counter()
    ckpt.save_latest(trainer, epoch=2, next_batch=1)
    save_s = time.perf_counter() - t0
    want = trainer.training_step(train[1])["train_total_loss"]
    want_p = params_of(trainer.models)

    fresh = fc.build_trainer(s, fc.build_models(s), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    position = type(ckpt)(ckpt.directory).restore_latest(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert position == (2, 1), position
    fresh.epoch = 2
    got = fresh.training_step(train[1])["train_total_loss"]
    got_p = params_of(fresh.models)
    report = {"save_latest_s": save_s, "restore_latest_s": restore_s,
              "loss": got.item(), "want_loss": want.item(),
              "loss_bits": bool(torch.equal(got, want)),
              "first_param_diff": first_difference(got_p, want_p)}
    report["same_bits"] = report["loss_bits"] and report["first_param_diff"] is None
    if not report["same_bits"]:
        report["param_max_abs"] = max((got_p[n] - want_p[n]).abs().max().item() for n in want_p)
        assert abs(report["loss"] - report["want_loss"]) <= STEP_LOSS_TOL * abs(
            report["want_loss"]), report

        def again() -> bool:  # two restores of the snapshot, one step each
            runs = []
            for _ in range(2):
                type(ckpt)(ckpt.directory).restore_latest(fresh)
                loss = fresh.training_step(train[1])["train_total_loss"]
                runs.append((loss, params_of(fresh.models)))
            (la, pa), (lb, pb) = runs
            return bool(torch.equal(la, lb)) and first_difference(pa, pb) is None

        report["nondeterminism"] = name_nondeterminism(again)
        assert report["nondeterminism"]["same_bits"], report
    results[key] = report
    log(f"{smi}: {key} " + json.dumps(report))
    del fresh, want_p, got_p
    free_device()


def eval_twice(results: dict, trainer, val) -> None:
    """The MC eval (real factors, fresh key samples) twice: the same bits."""
    import torch

    first, second = trainer.evaluate(val), trainer.evaluate(val)
    same = set(first) == set(second) and all(torch.equal(first[k], second[k]) for k in first)
    results["run_eval_twice_same_bits"] = same
    log(f"MC eval twice, {len(first)} metrics: same bits {same}")
    assert same, "two evaluations differ"


def unfrozen_step(results: dict, dev, smi: str, trainer, train) -> None:
    """One step past the unfreeze epoch: the backbone carries gradients
    (K2 through autograd over its plain f32 recompute). At batch 16,
    or, if it does not fit, the largest batch that does (halving)."""
    import torch

    trainer.epoch = 11
    batch = train[0]
    size = len(batch["pci"])
    while True:
        part = {k: ({n: v[:size] for n, v in batch[k].items()} if isinstance(batch[k], dict)
                    else batch[k][:size]) for k in batch}
        try:
            reset_peak()
            step_ms = cuda_ms(lambda: trainer.training_step(part), iters=1, warmup=1)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"unfrozen step at batch {size} does not fit in device memory")
            torch.cuda.empty_cache()
            size //= 2
            assert size >= 1, "no batch fits"
    backbone = trainer.models[next(iter(trainer.models))].video_backbone
    assert backbone.unfreeze
    grads = [p.grad for p in backbone.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads), "backbone grads"
    gmax = max(g.abs().max().item() for g in grads)
    assert gmax > 0.0, "the unfrozen backbone has no gradient"
    out = {"batch": size, "step_ms": step_ms, "peak_gib": peak_gib(), "backbone_grad_max": gmax}
    results["run_unfrozen"] = out
    log(f"{smi}: unfrozen step {json.dumps(out)}")
    trainer.epoch = 2


def steady_epochs(results: dict, dev, smi: str) -> dict:
    """``USE_EMBEDDING_CACHE=device``: epoch 1 fills the memo, epoch 2
    encodes nothing and runs no backbone (0 K1, 48 K3a a step; launches
    counted from 0 just before epoch 2 and read just after). The memo's
    features against the backbone's own; a steady step's loss against the
    cold step's on the same batch (dropout off, exhaustive); the steady
    step's time, the memo's encode and gather times."""
    import torch

    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.models.routeformer import fps_subsample_indices
    from routeformer_torch.train import CheckpointManager, MetricsLogger
    from routeformer_torch.train.losses import routeformer_training_loss

    set_fusion("1")
    s, train, val = run_setup(dev, {"USE_EMBEDDING_CACHE": "device", "SAVE_EVERY_STEPS": "0"})
    models = fc.build_models(s)
    trainer = fc.build_trainer(s, models, dev)
    model = models[fc.FLAGSHIP]
    memo = fc.build_precompute(s, models, dev)
    prepare = fc.make_prepare(memo)
    ckpt = CheckpointManager(s.results_dir / "checkpoints")
    metrics_logger = MetricsLogger(s.results_dir / "logs", experiment="smoke_steady")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepare(val[0])
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    encoded_val = memo.stats()["encoded"]
    fc.run_epochs(trainer, ckpt, metrics_logger, train, val, prepare, epochs=1)
    filled = memo.stats()
    reset_peak()
    reset_counts()  # the steady epoch: counts set to 0 just before, read just after
    history = fc.run_epochs(trainer, ckpt, metrics_logger, train, val, prepare,
                            start_epoch=1, epochs=2)
    torch.cuda.synchronize()
    launches = launch_counts()
    run_peak = peak_gib()
    metrics_logger.close()
    after = memo.stats()
    assert after["encoded"] == filled["encoded"], (filled, after)
    if dev.type == "cuda":
        assert launches["K1"] == 0 and launches["K2"] == 0, launches
        want = RUN_TRAIN * RUN_PER_STEP["K3a"] + RUN_VAL * MC_SAMPLES * PER_EVAL_FORWARD["K3a"]
        assert launches["K3a"] == want, f"steady epoch: K3a {launches['K3a']}, not {want}"

    warm = prepare(train[0])
    per_step = step_launches(lambda: trainer.training_step(warm))
    if dev.type == "cuda":
        assert per_step["K1"] == per_step["K2"] == 0, per_step
        assert per_step["K3a"] == RUN_PER_STEP["K3a"], per_step
    reset_peak()
    step_ms = cuda_ms(lambda: trainer.training_step(warm), iters=3, warmup=1)
    step_peak = peak_gib()
    profile = profile_step(lambda: trainer.training_step(warm), step_ms, results,
                           key="run_steady_profile")
    gather_ms = cuda_ms(lambda: prepare(train[0]), iters=3, warmup=1)

    # the memo against the backbone on the same frames (the val batch's left view)
    pixels = torch.from_numpy(val[0]["train"]["left_video"])
    cfg = model.configs
    idx = torch.from_numpy(fps_subsample_indices(pixels.shape[1],
                                                 cfg.output_fps // cfg.video_fps))
    frames = pixels[:, idx].flatten(0, 1).numpy()
    with torch.no_grad():
        own = model.video_backbone(torch.from_numpy(frames).to(dev))
    cached = memo.backbone(frames)
    memo_err = rel_err(cached, own)
    memo_bits = bool(torch.equal(cached.float(), own.float()))
    assert memo_err <= MEMO_TOL, f"memo features vs backbone: {memo_err}"

    quiet(model)
    with torch.no_grad():
        cold_loss, _ = routeformer_training_loss(model, trainer._place(train[0]["train"]),
                                                 trainer._place(train[0]["target"]), 12)
        steady_loss, _ = routeformer_training_loss(model, trainer._place(warm["train"]),
                                                   trainer._place(warm["target"]), 12)
    loss_rel = abs(steady_loss.item() - cold_loss.item()) / abs(cold_loss.item())
    assert loss_rel <= STEADY_LOSS_TOL, f"steady vs cold loss: {loss_rel}"
    out = {
        "epoch_seconds": history[0]["seconds"], "launches": launches,
        "run_peak_gib": run_peak, "memo": after,
        "encode_ms_per_novel_frame": 1e3 * encode_s / encoded_val,
        "encoded_frames_timed": encoded_val, "gather_ms_per_batch": gather_ms,
        "steady_step_ms": step_ms, "steady_step_peak_gib": step_peak,
        "steady_step_device_busy_ms": profile["device_busy_ms_per_step"],
        "steady_step_idle_share": profile["idle_share"],
        "steady_launches_per_step": per_step,
        "memo_vs_backbone_rel": memo_err, "memo_bits_equal": memo_bits,
        "steady_vs_cold_loss_rel": loss_rel,
    }
    results["run_steady"] = out
    log(f"{smi}: steady epochs {json.dumps(out)}")
    del trainer, models, model, memo
    free_device()
    return launches


def training_run(results: dict, smi: str, dev=None) -> dict:
    """Phase 7b. Returns the launches of the cold and the steady epochs."""
    import torch

    dev = torch.device("cuda") if dev is None else dev
    t0 = time.perf_counter()
    trainer_vs_step(results, dev)
    trainer, ckpt, s, train, val = cold_epochs(results, dev, smi)
    resume_check(results, dev, smi, trainer, ckpt, s, train)
    eval_twice(results, trainer, val)
    unfrozen_step(results, dev, smi, trainer, train)
    cold = results["run_cold"]["launches"]
    del trainer, ckpt
    free_device()
    steady = steady_epochs(results, dev, smi)
    log(f"training run phase: {time.perf_counter() - t0:.1f} s")
    return {"cold_epochs": cold, "steady_epoch": steady}


# --------------------------------------------------------------- phase 7f #

# The mesh at world size 1 over NCCL: phase 7b's settings and batches; the
# generator seeds of the two compared steps (the third, after the MC eval
# and the snapshot, takes the next seed).
MESH_SEEDS = (41, 42)
MESH_VARIANTS = ("mesh", "mesh_fsdp")


def mesh_trainer(s, dev, mesh, fsdp: bool):
    """The driver's flagship trainer past the warmup (epoch and update count
    at ``TRAIN_EPOCH``: the dense loss on), its backbone frozen as in phase
    7b's cold steps, without a mesh or on ``mesh``."""
    from routeformer_torch.experiments import full_comparison as fc

    s = dataclasses.replace(s, fsdp=fsdp)
    trainer = fc.build_trainer(s, fc.build_models(s), dev, mesh=mesh)
    trainer.unfreeze_epoch = None
    trainer.epoch = TRAIN_EPOCH
    trainer.optimizer.count = TRAIN_EPOCH
    return trainer


def mesh_steps(trainer, train, first=None) -> dict:
    """A step for each batch of ``train`` with ``MESH_SEEDS``; each step's
    launches counted from 0 just before and read just after, each step
    timed (CUDA events on the card). ``first`` (a ``StepRecord``) records
    the first step."""
    import torch

    cuda = trainer.device.type == "cuda"
    out = {"loss": [], "launches": [], "ms": []}
    for i, (seed, batch) in enumerate(zip(MESH_SEEDS, train)):
        torch.manual_seed(seed)
        reset_counts()
        if first is not None and i == 0:
            first.start(trainer)
        def step(b=batch):
            out["loss"].append(trainer.training_step(b)["train_total_loss"])

        if cuda:
            out["ms"].append(event_ms(step))
            torch.cuda.synchronize()
        else:
            t0 = time.perf_counter()
            step()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["launches"].append(launch_counts())
        if first is not None and i == 0:
            first.stop(trainer)
    return out


class StepRecord:
    """What the two-rank run compares of a first step: every module
    output's float64 sum and max|x| in call order (where two runs part, the
    first op is named), each Linear and convolution's forward FLOPs
    (``layout.counting_flops``), and the trained parameters' whole gradients and
    updates (phase 7's ``step_gap``), on the CPU. On a mesh the gradients
    and weights are gathered whole (every rank calls it)."""

    def __init__(self, model_name: str):
        self.name = model_name
        self.rows, self.handles = [], []

    def start(self, trainer) -> None:
        import torch

        from routeformer_torch.parallel.layout import counting_flops

        self.before = self._params(trainer)
        model = trainer.models[self.name]

        def hook(name):
            def record(module, _inp, out):
                out = out[0] if isinstance(out, tuple) else out
                split = getattr(module, "mesh_split", None)
                if split is not None and split.kept():  # this rank's columns only
                    self.rows.append((name, None))
                elif isinstance(out, torch.Tensor) and out.is_floating_point():
                    d = out.detach()
                    self.rows.append((name, torch.stack([d.double().sum(),
                                                         d.abs().max().double()])))
            return record

        self.handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
        self.counter = counting_flops(model)
        self.flops = self.counter.__enter__()

    def stop(self, trainer) -> None:
        self.counter.__exit__(None, None, None)
        del self.counter
        for h in self.handles:
            h.remove()
        self.rows = [(n, None if v is None else v.tolist()) for n, v in self.rows]
        after = self._params(trainer)
        grads = self._params(trainer, grads=True)
        self.step = {"grads": grads, "update": {n: after[n] - b for n, b in self.before.items()
                                                 if n in grads},
                     "lr": max(g["lr"] for g in trainer.optimizer.opt.param_groups)}
        del self.before

    def _params(self, trainer, grads: bool = False) -> dict:
        """The trained parameters (or their gradients) whole, on the CPU."""
        import torch

        from routeformer_torch.parallel.mesh import spec_gather

        layout = trainer.layouts.get(self.name)
        out = {}
        for n, p in trainer.models[self.name].named_parameters():
            t = p.grad if grads else p.detach()
            if t is None or not p.requires_grad:
                continue
            if layout is not None and p in layout.sharded:
                t = spec_gather(t, layout.sharded[p], layout.mesh)
            out[n] = t.detach().to("cpu", torch.float32, copy=True)
        return out


def first_difference_of(rows: list, want: list) -> dict:
    """The first module output (in call order) whose digest differs between
    two runs, with the relative gap of its sum and max|x| (a kept-split
    layer's output, a rank's columns only, is passed over)."""
    for (n, got), (m, ref) in zip(rows, want):
        if n != m:
            return {"module": n, "reference_module": m, "why": "the call order differs"}
        if got is not None and got != ref:
            return {"module": n, "sum_rel": abs(got[0] - ref[0]) / max(abs(ref[0]), 1e-30),
                    "max_rel": abs(got[1] - ref[1]) / max(abs(ref[1]), 1e-30)}
    return {"module": None, "rows": len(rows)}


def same_state(a, b) -> dict:
    """Whether two trainers' parameters are the same bits (the first that
    differs named)."""
    first = first_difference(dict(a.models.named_parameters()),
                             dict(b.models.named_parameters()))
    return {"same_bits": first is None, "first_param_diff": first}


# A kept column split's dropout (``parallel/mesh.py split_dropout``) against
# one process's on the card: ``full_comparison``'s Informer encoder ff1 output at
# batch 16 (the kept pair ``encdec.py`` routes through ``feature_dropout``),
# in bf16 as the flagship runs it and in f32 as the Autoformer layers do,
# cut into n_model = 2 column blocks.
DROPOUT_SHAPE = (16, 40, 3328)
DROPOUT_P = 0.1


def f32_split_draw(x, p: float, dim: int, n: int, rank: int):
    """The kept split's dropout as it was drawn before ``split_dropout``:
    the whole mask from f32 ones on CUDA, ``x`` times its block, rounded
    to ``x``'s dtype (a reading only, held to nothing)."""
    import torch
    import torch.nn.functional as F

    shape = list(x.shape)
    shape[dim] *= n
    noise = F.dropout(torch.ones(shape, dtype=torch.float32, device=x.device), p, True)
    size = x.shape[dim]
    return (x * noise.narrow(dim, rank * size, size)).to(x.dtype)


def split_dropout_check(smi: str, dev=None) -> dict:
    """Phase 7f, one process: from one generator state, ``F.dropout`` of
    the whole activation against the split's draw on each of two column
    blocks put back together (``split_dropout``; and the f32 draw it
    replaced, ``f32_split_draw``): the kept positions that differ (where
    ``x`` is not 0) and whether the outputs are the same bits. The split's
    draw must give one process's bits."""
    import torch
    import torch.nn.functional as F

    from routeformer_torch.parallel.mesh import split_dropout

    dev = torch.device("cuda") if dev is None else dev
    out = {"shape": list(DROPOUT_SHAPE), "p": DROPOUT_P, "n_model": 2, "smi": smi}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(DROPOUT_SHAPE, generator=torch.Generator().manual_seed(17))
        x = x.to(dev, dtype)
        blocks = [b.contiguous() for b in x.chunk(2, dim=-1)]  # a column split's outputs
        torch.manual_seed(23)
        state = torch.cuda.get_rng_state() if dev.type == "cuda" else torch.get_rng_state()
        restore = torch.cuda.set_rng_state if dev.type == "cuda" else torch.set_rng_state
        one = F.dropout(x, DROPOUT_P, True)
        rec = {}
        for label, draw in (("split_dropout", split_dropout), ("f32_draw", f32_split_draw)):
            parts = []
            for rank, block in enumerate(blocks):
                restore(state)
                parts.append(draw(block, DROPOUT_P, -1, 2, rank))
            got = torch.cat(parts, dim=-1)
            differ = ((got != 0) != (one != 0)) & (x != 0)
            rec[label] = {"kept_share_differs": differ.float().mean().item(),
                          "same_bits": bool(torch.equal(got, one))}
        rec["kept_share"] = ((one != 0) | (x == 0)).float().mean().item()
        out[str(dtype).removeprefix("torch.")] = rec
        assert rec["split_dropout"]["same_bits"], (dtype, rec)
        assert rec["split_dropout"]["kept_share_differs"] == 0.0, (dtype, rec)
    log(f"{smi}: mesh phase split dropout vs one process: {json.dumps(out)}")
    return out


def mesh_phase(results: dict, smi: str, dev=None, env=None) -> dict:
    """Phase 7f. Returns K1-K4's launches per mesh step (both variants).
    (``dev`` the CPU and ``env`` DEBUG widths rehearse it over gloo.)"""
    import socket

    import torch
    import torch.distributed as dist

    from routeformer_torch.parallel import init_distributed, make_mesh
    from routeformer_torch.train import CheckpointManager

    dev = torch.device("cuda") if dev is None else dev
    t0 = time.perf_counter()
    results["split_dropout"] = split_dropout_check(smi, dev)
    set_fusion("1")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rendezvous = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(rendezvous)
    cuda = dev.type == "cuda"
    init_distributed(None if cuda else dev, timeout_s=600)
    try:
        mesh = make_mesh(1, 1, device=dev)
        s, train, val = run_setup(dev, env)
        out = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
               "mesh": list(mesh.shape), "smi": smi}
        assert out["backend"] == ("nccl" if cuda else "gloo"), out

        def timed(trainer, key):
            if not cuda:
                return
            reset_peak()
            out[key + "_step_ms"] = cuda_ms(lambda: trainer.training_step(train[0]),
                                            iters=3, warmup=1)
            out[key + "_step_peak_gib"] = peak_gib()

        ref = mesh_trainer(s, dev, None, False)
        want_eval = ref.eval_batch_raw(val[0])  # the generator of the MC eval only
        want = mesh_steps(ref, train)
        ref_state = {n: p.detach().clone() for n, p in ref.models.named_parameters()}
        timed(ref, "no_mesh")
        del ref
        free_device()
        launches = {}
        for variant in MESH_VARIANTS:
            fsdp = variant == "mesh_fsdp"
            trainer = mesh_trainer(s, dev, mesh, fsdp)
            pcis, raw = trainer.eval_batch_raw(val[0])
            got = mesh_steps(trainer, train)
            rec = {"loss": [x.item() for x in got["loss"]],
                   "want_loss": [x.item() for x in want["loss"]],
                   "loss_bits": all(torch.equal(a, b) for a, b in zip(got["loss"], want["loss"])),
                   "launches_per_step": got["launches"],
                   "eval_bits": bool(torch.equal(pcis, want_eval[0]) and all(
                       torch.equal(a, b) for n in raw for a, b in zip(raw[n], want_eval[1][n]))),
                   "params_vs_no_mesh": first_difference(
                       {n: p.detach() for n, p in trainer.models.named_parameters()},
                       ref_state)}
            for per_step in got["launches"] if cuda else ():
                for k in ("K1", "K2", "K3a", "K4"):
                    assert per_step[k] == RUN_PER_STEP[k], (variant, per_step)
                assert 16 <= per_step["K3b"] <= 24, (variant, per_step)
            launches[variant] = got["launches"]
            rec["gather_units"] = sum(len(lay.units) for lay in trainer.layouts.values())
            rec["gathered_high_water_bytes"] = sum(
                lay.high_water for lay in trainer.layouts.values())
            assert rec["gather_units"] == 0 or dist.get_world_size() > 1, rec
            rec["same_bits"] = rec["loss_bits"] and rec["params_vs_no_mesh"] is None
            assert rec["eval_bits"], rec
            if fsdp:  # one data shard: FSDP shards nothing, the plain mesh's layout
                assert not any(lay.sharded or lay.splits for lay in trainer.layouts.values())
            if not rec["same_bits"]:  # phase 7's limit on the first step, the op named
                a, b = rec["loss"][0], rec["want_loss"][0]
                assert abs(a - b) <= STEP_LOSS_TOL * abs(b), rec
                rec["nondeterminism"] = out["mesh"].get("nondeterminism") if fsdp else \
                    name_nondeterminism(lambda: mesh_pair_bits(s, dev, mesh, fsdp, train))
                assert rec["nondeterminism"] and rec["nondeterminism"]["same_bits"], rec
            if fsdp:
                out[variant] = rec
                log(f"{smi}: mesh phase {variant}: {json.dumps(rec)}")
                del trainer
                free_device()
                continue
            # the snapshot: the next step of the uninterrupted run and of a
            # fresh trainer restoring it, cuDNN's convolution backward held
            # deterministic (phase 7b names it nondeterministic)
            ckpt = CheckpointManager(RUN_DIR / f"{variant}_checkpoints")
            torch.manual_seed(MESH_SEEDS[-1] + 1)  # saved with the snapshot
            ckpt.save_latest(trainer, TRAIN_EPOCH, next_batch=2)
            fresh = mesh_trainer(s, dev, mesh, fsdp)
            assert ckpt.restore_latest(fresh) == (TRAIN_EPOCH, 2)
            torch.backends.cudnn.deterministic = True
            try:
                again = fresh.training_step(train[-1])["train_total_loss"]
                fresh_state = {n: p.detach().clone() for n, p in fresh.models.named_parameters()}
                del fresh
                free_device()
                torch.manual_seed(MESH_SEEDS[-1] + 1)  # the generators as saved
                nxt = trainer.training_step(train[-1])["train_total_loss"]
            finally:
                torch.backends.cudnn.deterministic = False
            rec["restore"] = {"loss_bits": bool(torch.equal(again, nxt)), "first_param_diff":
                              first_difference(fresh_state, {
                                  n: p.detach() for n, p in trainer.models.named_parameters()}),
                              "held": "torch.backends.cudnn.deterministic"}
            assert rec["restore"]["loss_bits"] and rec["restore"]["first_param_diff"] is None, rec
            del fresh_state
            timed(trainer, variant)
            out[variant] = rec
            log(f"{smi}: mesh phase {variant}: {json.dumps(rec)}")
            del trainer
            free_device()
        out["launches"] = launches
        log(f"{smi}: mesh phase step ms / peak GiB: " + json.dumps(
            {k: v for k, v in out.items() if k.endswith(("_ms", "_gib"))}))
        log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
        results["mesh_run"] = out
        return {k: [step[k] for v in MESH_VARIANTS for step in launches[v]]
                for k in ("K1", "K2", "K3a", "K3b", "K4")}
    finally:
        dist.destroy_process_group()
        for var in rendezvous:
            os.environ.pop(var, None)


def mesh_pair_bits(s, dev, mesh, fsdp: bool, train) -> bool:
    """Two steps without a mesh and on it, from the same seeds: the same
    bits?"""
    import torch

    a = mesh_trainer(s, dev, None, False)
    want = mesh_steps(a, train)["loss"]
    b = mesh_trainer(s, dev, mesh, fsdp)
    got = mesh_steps(b, train)["loss"]
    same = all(torch.equal(x, y) for x, y in zip(got, want)) and \
        same_state(a, b)["same_bits"]
    del a, b
    free_device()
    return same


# The mesh's model axis split over two ranks sharing the one card (phase
# 7f): two processes (``parallel.dryrun.launch``) joined over gloo, which
# stages the collectives' CUDA tensors through the host (NCCL refuses two
# ranks on one device), each with its tensors and kernels on the card; the
# driver's flagship on a (1, 2) mesh at the driver's ``min_shard_dim``, one
# of phase 7b's batch-16 steps with the no-mesh reference's seed (a second,
# from weights one update apart, would be held to no limit: left out for the
# smoke's time, ~33 s).
TWO_RANK_MESH = (1, 2)
TWO_RANK_TIMEOUT_S = 400
# After the flagship, in the same two ranks: the zoo's GPS backbones at the
# flagship's GPS widths (d832, 8 heads, e6/d1, d_ff 3328; FEDformer's 32
# modes, the Wavelets blocks' c 128, k 8), f32, quiet, one step each of a
# batch of 16 synthetic GPS-and-feature series (a mean squared error
# against a synthetic target) on the (1, 2) mesh against the no-mesh step
# the parent takes on the card; then FEDformer Fourier on the same two
# processes as a (2, 1) data mesh (8 rows a rank, every parameter
# replicated: its gradients reduced in buckets during the backward). No
# FSDP on the card: gloo stages the CUDA collectives through the host, and
# the CPU tests hold FSDP.
TWO_RANK_MIN_SHARD = 512  # full_comparison's min_shard_dim
TWO_RANK_ZOO = ("Autoformer", "FEDformer-Fourier", "FEDformer-Wavelets")
TWO_RANK_DATA_MESH = (2, 1)
TWO_RANK_DATA_ZOO = "FEDformer-Fourier"
TWO_RANK_ZOO_BATCH = 16
ZOO_MESH_TOL = 1e-5  # f32: loss relative, each gradient over the largest gradient
# The no-mesh step's own movement under a relative one-ulp (2^-23) change of
# its input (a witness, as phase 7's bf16 limit): a backbone whose step
# moves more than ZOO_MESH_TOL / 2 under it is held to twice its movement.
ZOO_WITNESS_NOISE = 2.0 ** -23
ZOO_MESH_DIR = ROOT / "build" / "smoke_two_rank_zoo"


def zoo_backbone(name: str, dev, over=None):
    """``(backbone, config)``: a GPS backbone of ``TWO_RANK_ZOO`` at the
    flagship's GPS widths (``over``: fields replaced, for a rehearsal at
    small widths), seeded weights, train mode with every dropout rate 0,
    f32 on ``dev``."""
    import torch

    from routeformer_torch.flagship import GPS_VARIANTS, init_weights, variant_config

    cfg = variant_config(gps=name).gps_backbone_config
    for k, v in (over or {}).items():
        setattr(cfg, k, v)
    model = GPS_VARIANTS[name][0](cfg)
    init_weights(model, seed=3)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model.to(dev).train(), cfg


def zoo_inputs(cfg) -> tuple:
    """A batch of synthetic series and targets (numpy, f32)."""
    import numpy as np

    rng = np.random.default_rng(9)
    b = TWO_RANK_ZOO_BATCH
    return (rng.standard_normal((b, cfg.seq_len, cfg.enc_in), dtype=np.float32),
            rng.standard_normal((b, cfg.pred_len, cfg.c_out), dtype=np.float32))


def zoo_reference(dev, over=None) -> dict:
    """The parent's no-mesh step of each ``TWO_RANK_ZOO`` backbone: its
    loss, every splittable layer's forward FLOPs, the largest gradient and
    the gradients saved under ``ZOO_MESH_DIR`` (each rank reads its blocks
    through a memory map); the step again on its input moved by a relative
    ``ZOO_WITNESS_NOISE`` (the witness: loss and gradient movement) and the
    limits that gives; the inputs and settings the ranks take."""
    import torch

    from routeformer_torch.parallel.layout import counting_flops

    shutil.rmtree(ZOO_MESH_DIR, ignore_errors=True)
    ZOO_MESH_DIR.mkdir(parents=True)
    arg = {"over": over, "inputs": {}, "grads": {}, "scale": {}, "loss": {}, "flops": {},
           "ms": {}, "witness": {}, "limit": {}}
    for name in TWO_RANK_ZOO:
        model, cfg = zoo_backbone(name, dev, over)
        x, tgt = zoo_inputs(cfg)
        arg["inputs"][name] = (x, tgt)
        x, tgt = torch.from_numpy(x).to(dev), torch.from_numpy(tgt).to(dev)
        synchronize(dev)
        t0 = time.perf_counter()
        with counting_flops(model) as flops:
            loss = ((model(x) - tgt) ** 2).mean()
        loss.backward()
        synchronize(dev)
        arg["ms"][name] = 1e3 * (time.perf_counter() - t0)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        arg["scale"][name] = scale = max(g.abs().max().item() for g in grads.values())
        arg["loss"][name] = loss.item()
        arg["flops"][name] = dict(flops)
        arg["grads"][name] = str(ZOO_MESH_DIR / f"{name}.pt")
        torch.save(grads, arg["grads"][name])
        model.zero_grad(set_to_none=True)
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)).to(dev)
        moved = ((model(x * (1 + ZOO_WITNESS_NOISE * noise)) - tgt) ** 2).mean()
        moved.backward()
        w = {"loss_rel": abs(moved.item() - loss.item()) / abs(loss.item()),
             "grad_rel": max((p.grad.detach().cpu() - grads[n]).abs().max().item()
                             for n, p in model.named_parameters() if n in grads) / scale}
        arg["witness"][name] = w
        arg["limit"][name] = {k: max(ZOO_MESH_TOL, 2 * v) for k, v in w.items()}
        del model, grads, loss, moved
        if dev.type == "cuda":
            free_device()
    return arg


def zoo_mesh_step(name: str, dev, mesh, arg: dict, min_shard_dim: int) -> dict:
    """One rank's step of a zoo backbone on ``mesh`` (this rank's rows of
    the batch; the gradients reduced over ``data`` during the backward):
    the loss (the data shards' mean), each gradient's error over the
    reference's largest (this rank's blocks against the saved whole
    gradients), each split layer's forward FLOPs, the sharded weights
    gathered over ``model``, the data reductions launched before the
    backward returned, step ms, peak and the gathered high-water."""
    import torch

    from routeformer_torch.parallel.layout import counting_flops
    from routeformer_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        MeshParams,
        mean_over_data,
        row_block,
        spec_block,
    )

    model, _ = zoo_backbone(name, dev, arg["over"])
    layout = MeshParams(model, mesh, min_shard_dim, False)
    rows = row_block(TWO_RANK_ZOO_BATCH, mesh)
    x, tgt = (torch.from_numpy(a[rows]).to(dev) for a in arg["inputs"][name])
    names = {m: n for n, m in model.named_modules()}
    split = sorted(names[layer] for layer in layout.splits)
    over_model = set()
    gather = layout._gather

    def watched(p, *a, axes=(DATA_AXIS, MODEL_AXIS), **k):
        if MODEL_AXIS in axes and MODEL_AXIS in layout.sharded[p]:
            over_model.add(layout._names[p])
        return gather(p, *a, axes=axes, **k)

    layout._gather = watched
    if dev.type == "cuda":
        reset_peak()
    synchronize(dev)
    t0 = time.perf_counter()
    with layout.gathered():
        with counting_flops(model, set(split)) as flops:
            loss = ((model(x) - tgt) ** 2).mean()
        loss.backward()
        launched = layout.launched_in_backward
        layout.reduce_grads()
    synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    del layout._gather
    loss = mean_over_data({"loss": loss.detach()}, mesh)["loss"].item()
    ref = torch.load(arg["grads"][name], mmap=True)
    errs = {}
    for n, p in model.named_parameters():
        want = ref.get(n)
        if want is None:
            assert p.grad is None, n
            continue
        if p in layout.sharded:
            want = spec_block(want, layout.sharded[p], mesh)
        errs[n] = (p.grad.detach().cpu() - want).abs().max().item() / arg["scale"][name]
    worst = max(errs, key=errs.get)
    return {"mesh": list(mesh.shape), "loss": loss, "loss_rel": abs(loss - arg["loss"][name])
            / abs(arg["loss"][name]), "grad_rel": errs[worst], "worst_grad": worst,
            "split_layers": len(split), "flops": {k: flops[k] for k in split},
            "kinds": sorted({f"{type(layer).__name__} {sp.kind}"
                             for layer, sp in layout.splits.items()}),
            "split_params": len(layout.split_params), "gathered_over_model": sorted(over_model),
            "launched_in_backward": launched, "step_ms": ms,
            "peak_gib": peak_gib() if dev.type == "cuda" else None,
            "high_water_bytes": layout.high_water}


def zoo_two_rank(dev, mesh, arg: dict, min_shard_dim: int) -> dict:
    """The zoo's part of a rank's two-rank run: each ``TWO_RANK_ZOO``
    backbone on ``mesh`` ((1, 2)), then ``TWO_RANK_DATA_ZOO`` on a
    ``TWO_RANK_DATA_MESH`` over the same processes."""
    from routeformer_torch.parallel import make_mesh

    out = {}
    for name in TWO_RANK_ZOO:
        t0 = time.perf_counter()
        out[name] = zoo_mesh_step(name, dev, mesh, arg, min_shard_dim)
        out[name]["seconds"] = time.perf_counter() - t0
        if dev.type == "cuda":
            free_device()
    t0 = time.perf_counter()
    data_mesh = make_mesh(*TWO_RANK_DATA_MESH, device=dev)
    out["data_mesh"] = zoo_mesh_step(TWO_RANK_DATA_ZOO, dev, data_mesh, arg, min_shard_dim)
    out["data_mesh"]["seconds"] = time.perf_counter() - t0
    return out


def check_zoo_two_rank(ranks: list, arg: dict) -> None:
    """Each rank's zoo steps against the parent's no-mesh steps: loss and
    gradients within ``ZOO_MESH_TOL``, or twice the no-mesh step's own
    movement under a one-ulp change of its input where that is larger
    (``zoo_reference``); on the (1, 2) mesh every split
    layer's forward FLOPs exactly half the no-mesh step's and no split
    weight gathered over ``model``; on the (2, 1) mesh a data reduction
    launched before the backward returned."""
    for r in ranks:
        for name, rec in r["zoo"].items():
            key = TWO_RANK_DATA_ZOO if name == "data_mesh" else name
            limit = arg["limit"][key]
            assert rec["loss_rel"] <= limit["loss_rel"] and rec["grad_rel"] <= limit["grad_rel"], \
                (r["rank"], name, limit, rec)
            if name == "data_mesh":
                assert rec["launched_in_backward"] > 0 and rec["split_layers"] == 0, rec
                continue
            want = arg["flops"][key]
            assert rec["split_layers"] >= 20 and not rec["gathered_over_model"], (name, rec)
            assert {k: 2 * v for k, v in rec["flops"].items()} == \
                {k: want[k] for k in rec["flops"]}, (r["rank"], name, rec["flops"])


def two_rank(rank: int, n: int, arg=None) -> dict:
    """One rank of the two-rank run (the flagship quiet, as the reference):
    the step's launches, each split layer's forward FLOPs, the step's
    record (rank 0 returns it), its loss, ms, peak and the gathered
    high-water."""
    import torch

    from routeformer_torch.parallel import make_mesh
    from routeformer_torch.parallel.mesh import unit_gather_bytes, whole_weights

    from routeformer_torch.ops import cuda_build

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False  # as main()
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.libraries()  # built by the parent already: loaded, not rebuilt
    set_fusion("1")
    mesh = make_mesh(*TWO_RANK_MESH, device=dev)
    s, train, _ = run_setup(dev, fresh=False, n_train=1)
    trainer = mesh_trainer(s, dev, mesh, False)
    model, layout = trainer.models[FLAGSHIP], trainer.layouts[FLAGSHIP]
    quiet(model)
    names = {m: n for n, m in model.named_modules()}
    split = sorted(names[layer] for layer, sp in layout.splits.items()  # not in K3's stacks
                   if not whole_weights(layout._unit_modules[sp.unit]))
    first = StepRecord(FLAGSHIP)
    layout.reset_high_water()
    reset_peak()
    built_s = time.perf_counter() - t0
    got = mesh_steps(trainer, train, first)
    out = {"rank": rank, "split_layers": split, "flops": {k: first.flops[k] for k in split},
           "loss": [x.item() for x in got["loss"]], "launches": got["launches"],
           "step_ms": got["ms"], "high_water_bytes": layout.high_water,
           "largest_unit_bytes": max(layout.unit_bytes.values(), default=0),
           "largest_unit_unsplit_bytes": max(unit_gather_bytes(layout.units, layout.resident, {
               p: math.prod(layout.full_shapes[p]) * p.element_size() for p in layout.sharded
           }).values()),
           "split_params": len(layout.split_params), "min_shard_dim": layout.min_shard_dim,
           "peak_gib": peak_gib(), "built_s": built_s, "seconds": time.perf_counter() - t0}
    if rank == 0:
        out["rows"], out["step"] = first.rows, first.step
    del trainer, model, layout, first
    free_device()
    t1 = time.perf_counter()
    out["zoo"] = zoo_two_rank(dev, mesh, arg, TWO_RANK_MIN_SHARD)
    out["zoo_seconds"] = time.perf_counter() - t1
    return out


def two_rank_phase(results: dict, smi: str) -> None:
    """Phase 7f's two-rank run against the driver's flagship without a mesh
    (both quiet: dropout off, exhaustive ProbSparse, as phase 7's step
    comparisons): the step within phase 7's bf16 limits (``step_gap``: a
    step from the same weights) with the first differing op named; on each
    rank the step's launches 0/48/48/16-24 K1/K2/K3a/K3b, each split
    layer's forward FLOPs exactly half the no-mesh step's, the gathered
    high-water within the largest unit's without the split weights, beside
    the largest unit's with them (the per-unit gathers alone); step ms and
    peak of two ranks sharing one card over gloo (not a multi-card time)."""
    import torch

    from routeformer_torch.parallel.dryrun import launch

    t0 = time.perf_counter()
    s, train, _ = run_setup("cuda", fresh=False, n_train=1)
    trainer = mesh_trainer(s, torch.device("cuda"), None, False)
    quiet(trainer.models[FLAGSHIP])
    record = StepRecord(FLAGSHIP)
    want = mesh_steps(trainer, train, record)
    ref = {"flops": record.flops, "rows": record.rows, "step": record.step,
           "loss": [x.item() for x in want["loss"]], "step_ms": want["ms"]}
    del trainer, record, want
    free_device()
    zoo = zoo_reference(torch.device("cuda"))
    free_device()
    reference_s = time.perf_counter() - t0
    ranks = launch("chip_smoke:two_rank", TWO_RANK_MESH[0] * TWO_RANK_MESH[1], arg=zoo,
                   timeout_s=TWO_RANK_TIMEOUT_S, pg_timeout_s=300, pythonpath=[ROOT])
    first = ranks[0]
    gap = step_gap({"loss": first["loss"][0], **first.pop("step")},
                   {"loss": ref["loss"][0], **ref["step"]})
    out = {"mesh": list(TWO_RANK_MESH), "min_shard_dim": ranks[0]["min_shard_dim"], "smi": smi,
           "label": "two ranks sharing one card over gloo, not a multi-card time",
           "first_step_gap": gap, "first_difference": first_difference_of(
               first.pop("rows"), ref["rows"]),
           "loss": first["loss"], "want_loss": ref["loss"], "no_mesh_step_ms": ref["step_ms"],
           "ranks": ranks, "reference_s": reference_s, "seconds": time.perf_counter() - t0,
           "zoo_no_mesh": {k: {"loss": zoo["loss"][k], "step_ms": zoo["ms"][k],
                               "witness": zoo["witness"][k], "limit": zoo["limit"][k]}
                           for k in TWO_RANK_ZOO}}
    log(f"{smi}: mesh phase two ranks (1, 2) on one card over gloo: {json.dumps(out)}")
    results["mesh_two_rank"] = out
    check_zoo_two_rank(ranks, zoo)
    assert gap["loss_rel"] <= STEP_LOSS_TOL and gap["grad_rel"] <= STEP_TOLS["bf16"] and \
        gap["firm_update_lr"] <= 0.1 and gap["update_share_differs"] <= STEP_UPDATE_SHARE, out
    for r in ranks:
        assert r["split_layers"] and r["split_params"] > 0, r["rank"]
        assert {k: 2 * v for k, v in r["flops"].items()} == \
            {k: ref["flops"][k] for k in r["flops"]}, (r["rank"], r["flops"])
        assert r["high_water_bytes"] <= r["largest_unit_bytes"] <= \
            r["largest_unit_unsplit_bytes"], r
        for per_step in r["launches"]:
            for k in ("K1", "K2", "K3a", "K4"):
                assert per_step[k] == RUN_PER_STEP[k], (r["rank"], per_step)
            assert 16 <= per_step["K3b"] <= 24, (r["rank"], per_step)


# --------------------------------------------------------------- phase 7c #

# The driver's whole model zoo (MODEL_SET=full) through its pieces at batch
# 16, GEM geometry, full width, ROUTEFORMER_FUSION_KERNEL=1: one epoch of
# FULL_TRAIN train batches and FULL_VAL val batch.
FULL_ENV = {"DATASET": "GEM", "MODEL_SET": "full", "BATCH_SIZE": str(TRAIN_BATCH),
            "EPOCHS": "1", "SAVE_EVERY_STEPS": "0"}
FULL_TRAIN, FULL_VAL = 2, 1
FLAGSHIP = "Routeformer_with_video_with_gaze_swinv2"
# The JAX driver's 13 models (experiments/full_comparison.py), in its order.
FULL_MODELS = (
    FLAGSHIP, FLAGSHIP + "_autoreg_4s", FLAGSHIP + "_wout_scene", "AdaptedGIMO_swinv2",
    "MultiModalTransformer_swinv2", "Routeformer_with_video_swinv2", "AutoBotEgo",
    "Routeformer_without_video_informer", "Routeformer_without_video_transformer",
    "Routeformer_without_video_dlinear", "Routeformer_without_video_nlinear",
    "stationary_baseline", "linear_baseline",
)
SWIN_BLOCKS, PERCEIVE_LAYERS = 24, 8  # SwinV2-base's depth; the driver's encoder_layers
# Per model with video: (backbone calls a train step, an eval forward;
# Perceive stacks a train step, an eval forward; stacks that train in a
# step). A Routeformer with dense prediction runs its input forward and the
# target pass (one backbone call and its frame, video and gaze stacks
# each); gaze dropout zeroes the gaze features of a whole batch, and then
# the gaze encoder takes no gradient. AdaptedGIMO and the
# MultiModalTransformer encode each of their three views by one backbone
# call and one frame-encoder call and have no target pass. The GPS-only
# models launch nothing; no model reaches K1 (the driver's SwinV2 takes the
# exact gelu) or K4 (every attention is below 512 keys).
FULL_SET_DESIGN = {
    FLAGSHIP: (2, 1, 6, 3, (2, 3)),
    FLAGSHIP + "_autoreg_4s": (2, 1, 6, 3, (2, 3)),
    FLAGSHIP + "_wout_scene": (2, 1, 6, 3, (3,)),  # the front view; no gaze dropout
    "AdaptedGIMO_swinv2": (3, 3, 3, 3, (3,)),
    "MultiModalTransformer_swinv2": (3, 3, 3, 3, (3,)),
    "Routeformer_with_video_swinv2": (2, 1, 4, 2, (2,)),  # no gaze encoder
}
# The models whose class or config path is new with the zoo: a batch-1
# eval forward on the card against the CPU plain forward.
# (AdaptedGIMO's and the MultiModalTransformer's CPU forwards, 36-43 s each
# at one stage-2 pair, are left out for the smoke's time: their f32 K3a
# frame encoders are held against the plain stack in phase 6, at their
# geometries, ``K3_ZOO_GEOMS``.)
FULL_NEW_MODELS = (
    "AutoBotEgo", "Routeformer_without_video_transformer",
    "Routeformer_without_video_dlinear", "Routeformer_without_video_nlinear",
    FLAGSHIP + "_autoreg_4s", FLAGSHIP + "_wout_scene", "Routeformer_with_video_swinv2",
)
FULL_RUN_DIR = ROOT / "build" / "smoke_full"


def full_set_expected(name: str):
    """``(per train step, per eval forward)`` launches of one model; a step's
    K3b is a tuple of the counts gaze dropout allows."""
    calls_s, calls_f, stacks_s, stacks_f, trained = FULL_SET_DESIGN.get(
        name, (0, 0, 0, 0, (0,)))
    step = {"K1": 0, "K2": SWIN_BLOCKS * calls_s, "K3a": PERCEIVE_LAYERS * stacks_s,
            "K3b": tuple(PERCEIVE_LAYERS * t for t in trained), "K4": 0}
    forward = {"K1": 0, "K2": SWIN_BLOCKS * calls_f, "K3a": PERCEIVE_LAYERS * stacks_f,
               "K3b": 0, "K4": 0}
    return step, forward


class LaunchRecorder:
    """Launches per model on a ``ParallelTrainer``: in a train step from
    the start of one model's loss to the start of the next (its forward,
    target pass and backward), in eval per forward (hooks on the model).
    The counters are the wrappers' host-side counts, so no synchronisation
    is needed. ``close`` takes the wrappers and hooks off."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.steps, self.metrics = [], []
        self.forwards = {name: [] for name in trainer.model_names}
        self._loss_fn, self._step = trainer._loss_fn, trainer.training_step
        self._current = self._start = None
        self._open = {}

        def loss_fn(name, model, inp, tgt, epoch):
            self._mark(name)
            return self._loss_fn(name, model, inp, tgt, epoch)

        def training_step(batch):
            self._open = {}
            metrics = self._step(batch)
            self._mark(None)
            self.steps.append(self._open)
            self.metrics.append(metrics)
            return metrics

        trainer._loss_fn, trainer.training_step = loss_fn, training_step
        self.hooks = []
        for name, model in trainer.models.items():
            self.hooks.append(model.register_forward_pre_hook(self._pre(name)))
            self.hooks.append(model.register_forward_hook(self._post(name)))

    @staticmethod
    def _diff(now, start):
        return {k: v - start[k] for k, v in now.items()}

    def _mark(self, name):
        now = launch_counts()
        if self._current is not None:
            self._open[self._current] = self._diff(now, self._start)
        self._current, self._start = name, now

    def _pre(self, name):
        def hook(module, _args):
            if not module.training:
                module._launch_start = launch_counts()
        return hook

    def _post(self, name):
        def hook(module, _args, _out):
            if not module.training:
                self.forwards[name].append(self._diff(launch_counts(), module._launch_start))
        return hook

    def close(self):
        for h in self.hooks:
            h.remove()
        self.trainer._loss_fn = self._loss_fn
        del self.trainer.training_step  # the class's method again


def check_full_launches(rec, launches: dict, n_forwards: int) -> dict:
    """Every model's launches per step and per eval forward against
    ``full_set_expected``, and the run's totals against their sum."""
    table, total = {}, {k: 0 for k in launches}
    for name in FULL_MODELS:
        want_s, want_f = full_set_expected(name)
        steps = [step.get(name, {k: 0 for k in launches}) for step in rec.steps]
        forwards = rec.forwards[name]
        assert len(forwards) == n_forwards, (name, len(forwards))
        for counts in steps:
            for k, v in counts.items():
                ok = v in want_s[k] if k == "K3b" else v == want_s[k]
                assert ok, f"{name}: {k} {v} launches a step, not {want_s[k]}"
                total[k] += v
        for counts in forwards:
            assert counts == want_f, f"{name}: eval forward {counts}, not {want_f}"
            for k, v in counts.items():
                total[k] += v
        table[name] = {"per_step": steps, "per_eval_forward": forwards[0]}
    assert total == launches, f"full set: run {launches}, per model {total}"
    return table


def rebuild_on_cpu(model):
    """A CPU copy of a driver model (same class, config and weights)."""
    from routeformer_torch.baselines import AutoBotAdapted

    kwargs = {}
    if not isinstance(model, AutoBotAdapted):
        if hasattr(model, "gps_backbone"):
            kwargs["gps_backbone"] = type(model.gps_backbone)
        if hasattr(model, "video_backbone"):
            kwargs["video_backbone"] = type(model.video_backbone)
    cpu = type(model)(model.configs, **kwargs)
    cpu.load_state_dict(model.state_dict())
    return cpu.eval()


def cut_depth(model, n: int):
    """The video backbone cut to ``n`` (SwinV2's stage-2 pairs, the ViT's
    blocks); returns the restore function."""
    bb = model.video_backbone
    owner, attr = (bb.stages[2], "pairs") if hasattr(bb, "stages") else (bb, "blocks")
    full = getattr(owner, attr)
    setattr(owner, attr, full[:n])
    return lambda: setattr(owner, attr, full)


def free_device() -> None:
    """Collect the reference cycles a trainer keeps (its bound loss
    function) before returning cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


class CardVsCpu:
    """Batch-1 eval forwards of driver models on the card against the CPU
    plain forward of the same weights, exhaustive ProbSparse. The clip is
    moved so that its last GPS fix is the origin: every model reads only
    GPS differences and adds its motion onto the last fix, so the
    prediction is then the motion itself, which f32 resolves in full (at
    the synthetic fixes' 1e4 m an f32 ulp is 1e-3 m). ``card`` runs a
    model's card forward now (its ProbSparse factors restored after) and
    copies its weights to a CPU model, both cut to ``depth`` where given
    (``cut_depth``: SwinV2-base's stage 2 keeps that many of its 9 block
    pairs, so at 1 the CPU forward runs 8 of the 24 blocks), on the batch
    given at construction or its own; ``start`` runs the CPU forwards in a
    thread (CPU_THREADS of the host's cores), so they overlap the card's
    work; ``check`` joins it and holds max|diff|/max|cpu| of the
    prediction and, where the model predicts them, the dense features to
    PRED_TOL.

    ``witness=True`` (the PatchTST flagship, whose prediction is
    ill-conditioned in its visual features: ``PATCHTST_E2E_TOL``) also
    takes, on both sides, the GPS backbone's input and output, the
    forward with the video encoder's output moved by a relative 2^-9 of
    one seeded noise (the model's own movement), the CPU GPS backbone on
    the card's input, and the card forward with the fused stack off; it
    holds the GPS backbone's input and PatchTST on the card's input to
    PRED_TOL and the prediction to ``PATCHTST_E2E_TOL``."""

    CPU_THREADS = 6
    NOISE = 2 ** -9

    def __init__(self, batch: dict, place):
        self.one = self._one(batch)
        self.place = place
        self.cards, self.cpus, self.refs, self.seconds = {}, {}, {}, {}
        self.batches, self.witness = {}, {}
        self.thread = self.error = None

    @staticmethod
    def _one(batch: dict) -> dict:
        """The first row, its GPS moved so that its last fix is the origin."""
        import numpy as np

        one = {k: v[:1] for k, v in batch.items()}
        gps = one["gps"]
        one["gps"] = (gps.astype(np.float64) - gps[:, -1:]).astype(gps.dtype)
        return one

    @staticmethod
    def _forward(model, batch, hooks=()):
        import torch

        handles = [module.register_forward_hook(fn) for module, fn in hooks]
        try:
            with torch.inference_mode():
                out = model(batch)
        finally:
            for h in handles:
                h.remove()
        return tuple(o.float().cpu() for o in (out if isinstance(out, tuple) else (out,)))

    def _hooks(self, model, seen: dict, key: str, noise: bool):
        """Forward hooks: the GPS backbone's input and output into
        ``seen[key]``, or the video encoder's output moved by the noise."""
        import torch

        if not noise:
            def capture(_module, args, out):
                seen[key] = (args[0].float().cpu(), out.float().cpu())
            return [(model.gps_backbone, capture)]

        def perturb(_module, _args, out):
            gen = torch.Generator().manual_seed(0)  # the same noise on both sides
            n = torch.randn(out.shape, generator=gen).to(out.device)
            return (out.float() * (1 + self.NOISE * n)).to(out.dtype)
        return [(model.video_encoder, perturb)]

    def card(self, name: str, model, witness: bool = False, depth=None, batch=None) -> None:
        import torch

        from routeformer_torch.models.layers import ProbAttention

        layers = [m for m in model.modules() if isinstance(m, ProbAttention)]
        factors = [m.factor for m in layers]
        set_exhaustive(model)
        was_training = model.training
        model.eval()
        one = self.one if batch is None else self._one(batch)
        self.batches[name] = one
        batch = self.place(one)
        w = {}
        restore = cut_depth(model, depth) if depth else None
        try:
            hooks = self._hooks(model, w, "card", noise=False) if witness else ()
            out = self._forward(model, batch, hooks)
            if witness:
                w["card_moved"] = self._forward(model, batch,
                                                self._hooks(model, w, "", noise=True))
                fusion = os.environ.get("ROUTEFORMER_FUSION_KERNEL", "0")
                set_fusion("0")
                try:
                    w["card_plain_stack"] = self._forward(model, batch)
                finally:
                    set_fusion(fusion)
        finally:
            model.train(was_training)
            for m, f in zip(layers, factors):
                m.factor = f
            if restore:
                restore()
        assert all(torch.isfinite(o).all() for o in out), name
        self.cards[name] = out
        cpu = rebuild_on_cpu(model)
        if depth:
            cut_depth(cpu, depth)
        set_exhaustive(cpu)
        self.cpus[name] = cpu
        if witness:
            self.witness[name] = w

    def _run(self) -> None:
        import torch

        try:
            for name, cpu in self.cpus.items():
                batch = {k: torch.from_numpy(v) for k, v in self.batches[name].items()}
                t0 = time.perf_counter()
                w = self.witness.get(name)
                hooks = self._hooks(cpu, w, "cpu", noise=False) if w is not None else ()
                self.refs[name] = self._forward(cpu, batch, hooks)
                self.seconds[name] = time.perf_counter() - t0
                if w is not None:
                    w["cpu_moved"] = self._forward(cpu, batch,
                                                   self._hooks(cpu, w, "", noise=True))
                    with torch.inference_mode():
                        w["head"] = cpu.gps_backbone(w["card"][0]).float()
        except BaseException as e:  # re-raised by check
            self.error = e

    def start(self) -> None:
        import threading

        import torch

        self.threads_before = torch.get_num_threads()
        torch.set_num_threads(min(self.CPU_THREADS, os.cpu_count() or 1))
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    @staticmethod
    def _gaps(got, want) -> dict:
        e = {"displacement": rel_err(got[0], want[0])}
        if len(want) > 1:
            e["dense"] = rel_err(got[1], want[1])
        return e

    def check(self) -> dict:
        import torch

        if self.thread is not None:
            self.thread.join()
            torch.set_num_threads(self.threads_before)
        if self.error is not None:
            raise self.error
        errs = {}
        for name, card in self.cards.items():
            ref = self.refs[name]
            assert card[0].shape == ref[0].shape, (name, card[0].shape, ref[0].shape)
            e = dict(self._gaps(card, ref), cpu_s=self.seconds[name])
            w = self.witness.get(name)
            if w is None:
                tol = {"displacement": PRED_TOL, "dense": PRED_TOL}
            else:
                tol = PATCHTST_E2E_TOL
                e["gps_backbone_input"] = rel_err(w["card"][0], w["cpu"][0])
                e["patchtst_on_the_cards_input"] = rel_err(w["card"][1], w["head"])
                for label, (got, want) in {"own_movement_card": (w["card_moved"], card),
                                           "own_movement_cpu": (w["cpu_moved"], ref),
                                           "plain_stack_card": (w["card_plain_stack"], ref),
                                           }.items():
                    e.update({f"{label}_{k}": v for k, v in self._gaps(got, want).items()})
                assert e["gps_backbone_input"] <= PRED_TOL, (name, e)
                assert e["patchtst_on_the_cards_input"] <= PRED_TOL, (name, e)
            assert all(e[k] <= tol[k] for k in ("displacement", "dense") if k in e), (name, e)
            errs[name] = e
        self.cpus.clear()
        return errs


class StackShapes:
    """The ``(rows, tokens, bf16)`` of every K3a and K3b call while open
    (the wrappers are wrapped, so nothing is launched more), held against
    the geometries phase 6 checks each kernel at."""

    def __init__(self):
        from routeformer_torch.ops import fusion_stack as fs

        self.fs, self.fwd, self.bwd = fs, set(), set()
        self._orig = fs.stack_forward_cuda, fs.layer_backward_cuda

        def record(seen, fn):
            def wrapper(x, *args, compute_bf16, **kwargs):
                seen.add((x.shape[0], x.shape[1], compute_bf16))
                return fn(x, *args, compute_bf16=compute_bf16, **kwargs)
            return wrapper

        fs.stack_forward_cuda = record(self.fwd, self._orig[0])
        fs.layer_backward_cuda = record(self.bwd, self._orig[1])

    def close(self) -> dict:
        self.fs.stack_forward_cuda, self.fs.layer_backward_cuda = self._orig
        checked = {(r, l) for _, r, l, _ in K3_GEOMS + K3_ZOO_GEOMS}  # both precisions
        backward = {(r, l, name not in K3_F32) for name, r, l, _ in K3_BACKWARD_GEOMS}
        assert {(r, l) for r, l, _ in self.fwd} <= checked, (self.fwd, checked)
        assert self.bwd <= backward, (self.bwd, backward)
        return {"K3a": sorted(self.fwd), "K3b": sorted(self.bwd)}


def full_set_run(results: dict, smi: str, dev=None) -> dict:
    """Phase 7c. Returns each kernel's launches per full-set step and per
    eval forward."""
    import torch

    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.train import CheckpointManager, MetricsLogger

    dev = torch.device("cuda") if dev is None else dev
    t0 = time.perf_counter()
    set_fusion("1")
    s = fc.Settings.from_env(dict(FULL_ENV, RESULTS_DIR=str(FULL_RUN_DIR)))
    shutil.rmtree(FULL_RUN_DIR, ignore_errors=True)
    train_data, val_data = fc.build_data(s)
    train = [train_data[i] for i in range(FULL_TRAIN)]
    val = [val_data[i] for i in range(FULL_VAL)]
    models = fc.build_models(s)
    assert tuple(models) == FULL_MODELS, list(models)
    trainer = fc.build_trainer(s, models, dev)
    baselines = [n for n in FULL_MODELS if "baseline" in n]
    assert list(trainer.trained) == [n for n in FULL_MODELS if n not in baselines]
    assert not any(list(models[n].parameters()) for n in baselines)
    assert len(trainer.optimizer.params) == len(list(trainer.trained.parameters()))
    build_s = time.perf_counter() - t0
    # the new paths' card forwards now; their CPU references overlap the run
    card_cpu = CardVsCpu(val[0]["train"], trainer._place)
    for name in FULL_NEW_MODELS:
        card_cpu.card(name, trainer.models[name])
    card_cpu.start()
    frozen = {n: p.detach().clone() for n, p in trainer.trained.named_parameters()
              if ".video_backbone." in f".{n}"}
    rest = {n: p.detach().clone() for n, p in trainer.trained.named_parameters()
            if n not in frozen}

    rec = LaunchRecorder(trainer)
    ckpt = CheckpointManager(s.results_dir / "checkpoints")
    metrics_logger = MetricsLogger(s.results_dir / "logs", experiment="smoke_full")
    shapes = StackShapes() if dev.type == "cuda" else None
    reset_peak()
    reset_counts()  # the main path: counts set to 0 just before, read just after
    history = fc.run_epochs(trainer, ckpt, metrics_logger, train, val, lambda b: b,
                            epochs=s.epochs)
    torch.cuda.synchronize()
    launches = launch_counts()
    run_peak = peak_gib()
    stack_shapes = shapes.close() if shapes is not None else None
    metrics_logger.close()
    rec.close()
    if dev.type == "cuda":  # on the CPU the wrappers run their plain versions, uncounted
        table = check_full_launches(rec, launches, FULL_VAL * MC_SAMPLES)
    else:
        table = {n: {"per_step": [st.get(n) for st in rec.steps],
                     "per_eval_forward": rec.forwards[n][0]} for n in FULL_MODELS}
    for metrics in rec.metrics:
        values = {k: v.item() for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in values.values()), values
        assert {f"train_loss_{n}" for n in trainer.trained} <= set(values)
    for h in history:
        assert all(math.isfinite(float(v)) for v in h["val"].values()), h
    assert set(ckpt.best) == set(FULL_MODELS), ckpt.best
    params = dict(trainer.trained.named_parameters())
    assert all(torch.equal(params[n], p) for n, p in frozen.items()), "a frozen backbone moved"
    moved = {name: any(not torch.equal(params[n], p) for n, p in rest.items()
                       if n.startswith(name + "."))
             for name in trainer.trained}
    assert all(moved.values()), f"trained parameters that did not move: {moved}"
    del frozen, rest, params
    per_step = {k: [sum(c[k] for c in step.values()) for step in rec.steps] for k in launches}
    per_forward = {k: sum(table[n]["per_eval_forward"][k] for n in FULL_MODELS)
                   for k in launches}
    log("full set launches per model (per step, per eval forward): " + json.dumps(
        {n: {"step": t["per_step"], "forward": t["per_eval_forward"]}
         for n, t in table.items()}))

    card_cpu = card_cpu.check()  # the CPU references, joined before the timings

    b0 = train[0]
    reset_peak()
    step_ms = cuda_ms(lambda: trainer.training_step(b0), iters=2, warmup=1)
    step_peak = peak_gib()
    profile = profile_step(lambda: trainer.training_step(b0), step_ms, results,
                           key="full_step_profile")
    reset_peak()
    eval_ms = cuda_ms(lambda: trainer.eval_batch_raw(val[0]), iters=1, warmup=0)
    eval_peak = peak_gib()

    # the autoregressive model's MC eval, twice: the same bits
    autoreg = FLAGSHIP + "_autoreg_4s"
    first, second = (trainer.eval_batch_raw(val[0], names=[autoreg])[1][autoreg]
                     for _ in range(2))
    autoreg_bits = all(torch.equal(a, b) for a, b in zip(first, second))
    assert autoreg_bits, "the autoregressive model's MC eval differs between two runs"
    assert models[autoreg].gps_backbone.pred_len == s.pred_len
    del trainer, ckpt, models, rec
    free_device()
    patch = patchtst_step(results, dev, smi)
    card_cpu["PatchTST " + FLAGSHIP] = patch.pop("card_vs_cpu")
    log("full set, card vs CPU (batch 1, exhaustive), max|diff|/max|cpu|: "
        + json.dumps(card_cpu))

    out = {
        "models": list(FULL_MODELS), "build_s": build_s,
        "epoch_seconds": history[0]["seconds"], "launches": launches,
        "run_peak_gib": run_peak, "step_ms": step_ms, "step_peak_gib": step_peak,
        "step_device_busy_ms": profile["device_busy_ms_per_step"],
        "step_idle_share": profile["idle_share"],
        "mc_eval_ms_per_batch": eval_ms, "mc_eval_peak_gib": eval_peak,
        "launches_per_step": per_step, "launches_per_eval_forward": per_forward,
        "autoreg_eval_twice_same_bits": autoreg_bits,
        "card_vs_cpu": card_cpu, "patchtst": patch, "stack_shapes": stack_shapes,
        "allocated_gib_after": (torch.cuda.memory_allocated() / 2 ** 30
                                if dev.type == "cuda" else None),
        "seconds": time.perf_counter() - t0,
    }
    results["full_set"] = out
    log(f"{smi}: full set {json.dumps(out)}")
    return {k: {"per_step": per_step[k], "per_eval_forward": per_forward[k]}
            for k in launches}


def patchtst_step(results: dict, dev, smi: str) -> dict:
    """``USE_PATCHTST_BACKBONE=1``: the flagship over PatchTST through the
    driver, one train step at batch 16: finite metrics, its BatchNorm
    running statistics moved; then its batch-1 card forward against the CPU
    plain forward (``CardVsCpu`` with its witnesses)."""
    import torch

    from routeformer_torch.experiments import full_comparison as fc

    s = fc.Settings.from_env(dict(FULL_ENV, MODEL_SET="flagship", USE_PATCHTST_BACKBONE="1",
                                  RESULTS_DIR=str(FULL_RUN_DIR)))
    models = fc.build_models(s)
    model = models[FLAGSHIP]
    assert type(model.gps_backbone).__name__ == "PatchTST"
    trainer = fc.build_trainer(s, models, dev)
    trainer.epoch = TRAIN_EPOCH
    train, val = fc.build_data(s)
    stats = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    # two BatchNorm sublayers of two buffers in each encoder layer
    assert len(stats) == 4 * model.configs.gps_backbone_config.e_layers, len(stats)
    metrics = trainer.training_step(train[0])
    values = {k: v.item() for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in values.values()), values
    buffers = dict(model.named_buffers())
    unmoved = [n for n, b in stats.items() if torch.equal(buffers[n], b)]
    assert not unmoved, f"BatchNorm statistics that did not move: {unmoved}"
    card_cpu = CardVsCpu(val[0]["train"], trainer._place)
    card_cpu.card(FLAGSHIP, model, witness=True)
    card_cpu._run()
    out = {"loss": values[f"train_loss_{FLAGSHIP}"], "batchnorm_buffers_moved": len(stats),
           "card_vs_cpu": card_cpu.check()[FLAGSHIP]}
    log(f"{smi}: PatchTST flagship step {json.dumps(out)}")
    del trainer, models, model
    free_device()
    return out


# --------------------------------------------------------------- phase 7d #

# The GEM data path: a recording written by the port's writer
# (``io/gem_fixture.py``), read by its readers, loaded by its loader and
# trained on by the driver's flagship. Subjects 001 and 003 are the train
# split, 002 the val split. The train subjects take 46 s, so that the
# train split has 32 windows (two batches of 16: the steps are timed after
# the first; 62 s gave three, cut for the smoke's time); the val subject
# 62 s, so that 18 of its 24 windows pass MIN_PCI 20 (one val batch of 16
# needs 16). The GoPro pair at (540, 960) and the
# world camera at (544, 540), scaled 0.4 and 0.6, reach the model at the
# driver's real GEM geometry: GoPro crop (216, 153), front (326, 324).
GEM_SUBJECTS = (("001", 0), ("003", 20), ("002", 10))  # (subject, seed)
GEM = {"duration_s": 62.0, "train_duration_s": 46.0, "gopro_hw": (540, 960), "world_hw": (544, 540), "fps": 5.0,
       "scaling": (0.4, 0.6), "turn": 1.0, "batch": TRAIN_BATCH, "env": {}}
GEM_RUN_DIR = ROOT / "build" / "smoke_gem"
GEM_TIMED_FRAMES = 12  # frames per host-op timing


def gem_windows(duration_s: float) -> int:
    """Windows the indexer makes of one subject: starts 0, 2, ... s while
    the 14 s window fits the aligned duration (the world video starts
    0.35 s late)."""
    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.io.gem_fixture import WORLD_LAG_S

    span = (duration_s - WORLD_LAG_S
            - (fc.INPUT_LENGTH_SECONDS + fc.TARGET_LENGTH_SECONDS))
    return int(span // fc.STEP_SIZE_SECONDS) + 1 if span >= 0 else 0


def gem_duration(geo: dict, subject: str) -> float:
    """A subject's seconds: the val subject (the last of GEM_SUBJECTS)
    ``duration_s``, the train subjects ``train_duration_s``."""
    return geo["duration_s"] if subject == GEM_SUBJECTS[-1][0] else geo["train_duration_s"]


def write_gem_recording(root: Path, geo: dict) -> dict:
    """The three subjects, halving the duration while the disk cannot
    hold them twice over."""
    from routeformer_torch.io.gem_fixture import build_gem_fixture

    seconds = geo["duration_s"] + 2 * geo["train_duration_s"]
    need = int(seconds * geo["fps"]) * 3 * (2 * math.prod(geo["gopro_hw"])
                                            + math.prod(geo["world_hw"]))
    free = shutil.disk_usage(root).free
    cuts = []
    while 2 * need > free and geo["duration_s"] > 30:
        geo = dict(geo, duration_s=geo["duration_s"] / 2,
                   train_duration_s=geo["train_duration_s"] / 2)
        need //= 2
        cuts.append(f"durations halved to {geo['train_duration_s']} and "
                    f"{geo['duration_s']} s: {free / 1e9:.1f} GB free")
    t0 = time.perf_counter()
    for subject, seed in GEM_SUBJECTS:
        build_gem_fixture(root, duration_s=gem_duration(geo, subject), subject=subject,
                          hw=geo["gopro_hw"], world_hw=geo["world_hw"], fps=geo["fps"],
                          seed=seed, turn=geo["turn"])
    nbytes = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    return {"geo": geo, "seconds": time.perf_counter() - t0, "bytes": nbytes,
            "disk_free_bytes": free, "cuts": cuts}


def same_bits(placed: dict, want: dict, where: str) -> None:
    """A placed batch against ``torch.from_numpy`` of the numpy batch it
    was collated from (float64 placed as float32): the same bits."""
    import numpy as np
    import torch

    from routeformer_torch.io.loader import canonical

    for k, v in want.items():
        if isinstance(v, dict):
            same_bits(placed[k], v, f"{where}.{k}")
            continue
        ref = torch.from_numpy(np.ascontiguousarray(canonical(np.asarray(v))))
        got = placed[k].cpu()
        assert got.dtype == ref.dtype and torch.equal(got, ref), f"{where}.{k} differs"


def synchronize(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def loader_epoch(loader, epoch: int) -> dict:
    """One epoch of ``loader`` with no model: the batches (kept on the
    card), the wall time, bytes copied and the frame store's counts."""
    loader.set_epoch(epoch)
    order = loader.batch_indices()
    before = {k: dict(v) for k, v in loader.frame_store_stats().items()}
    copied = loader.bytes_copied
    t0 = time.perf_counter()
    batches = list(loader)
    synchronize(loader.device)
    seconds = time.perf_counter() - t0
    stats = loader.frame_store_stats()
    seen = sum(v["seen"] - before.get(k, {}).get("seen", 0) for k, v in stats.items())
    shipped = sum(v["shipped"] - before.get(k, {}).get("shipped", 0) for k, v in stats.items())
    store_bytes = sum(v["bytes_shipped"] - before.get(k, {}).get("bytes_shipped", 0)
                      for k, v in stats.items())
    n = len(batches)
    return {"batches": batches, "order": order, "seconds": seconds,
            "samples_per_s": n * loader.batch_size / seconds, "ms_per_batch": 1e3 * seconds / n,
            "bytes_copied_per_batch": (loader.bytes_copied - copied + store_bytes) / n,
            "frames_seen": seen, "frames_shipped": shipped,
            "shipped_share": shipped / max(seen, 1),
            "per_stream": {k: {"seen": v["seen"] - before.get(k, {}).get("seen", 0),
                               "shipped": v["shipped"] - before.get(k, {}).get("shipped", 0),
                               "capacity": v["capacity"]} for k, v in stats.items()}}


def check_epoch_bits(loader, epoch: dict) -> None:
    """Every batch of an epoch against ``default_collate`` of its samples
    (served again from the dataset's memory tier, the same arrays)."""
    from routeformer_torch.io.loader import default_collate

    for b, (placed, idx) in enumerate(zip(epoch["batches"], epoch["order"])):
        same_bits(placed, default_collate([loader.dataset[int(i)] for i in idx]),
                  f"batch {b}")


def check_distinct_keys(dataset, order) -> dict:
    """Distinct source frames give distinct content keys after the
    transforms: each window's frames (train and target) are pairwise
    distinct, and no key is shared between two subjects."""
    import numpy as np

    from routeformer_torch.io.frame_store import hash_frames

    keys_of = {}
    for i in (int(i) for idx in order for i in idx):
        sample, subject = dataset[i], dataset._indexer[i]["subject"]
        for stream in ("left_video", "right_video", "front_video"):
            frames = np.concatenate([sample["train"][stream], sample["target"][stream]])
            keys = hash_frames(np.ascontiguousarray(frames))
            assert len(set(keys)) == len(keys), f"sample {i} {stream}: repeated frames"
            keys_of.setdefault(subject, set()).update(keys)
    subjects = sorted(keys_of)
    for a in range(len(subjects)):
        for b in range(a + 1, len(subjects)):
            assert not keys_of[subjects[a]] & keys_of[subjects[b]], "subjects share frames"
    return {s: len(k) for s, k in keys_of.items()}


def host_op_times(dataset, root: Path, geo: dict) -> dict:
    """Host ms per source frame, one thread: the raw read, the undistort
    (GoPro: only the columns the crop keeps) and the resize, for a GoPro
    and the world video."""
    from routeformer_torch.io.video import open_capture
    from routeformer_torch.ops.image import crop_columns, remap_table, resize_table

    meta = next(iter(dataset.subject_sample_metadatas["001"].values()))["gaze_metadata"]
    cams = {"gopro": (root / "01GoPro" / "001" / "left" / "GH010008.MP4",
                      dataset.LEFT_VIDEO_CAMERA_INTRINSICS,
                      dataset.LEFT_VIDEO_DISTORTION_COEFFICIENTS, True, geo["scaling"][0]),
            "front": (root / "02EyeTracker" / "001" / "world.mp4", meta["camera_matrix"],
                      meta["dist_coefs"], False, geo["scaling"][1])}
    out = {}
    for name, (path, k, d, crop, scale) in cams.items():
        cap = open_capture(path)
        t0 = time.perf_counter()
        frames = [cap.read()[1] for _ in range(GEM_TIMED_FRAMES)]
        read_ms = 1e3 * (time.perf_counter() - t0) / GEM_TIMED_FRAMES
        cap.release()
        h, w = frames[0].shape[:2]
        table = remap_table(k, d, h, w)
        cols = crop_columns(w) if crop else slice(None)
        t0 = time.perf_counter()
        und = [table.apply(f[None], cols) for f in frames]
        und_ms = 1e3 * (time.perf_counter() - t0) / GEM_TIMED_FRAMES
        uh, uw = und[0].shape[1:3]
        resize = resize_table((uh, uw), (int(uh * scale), int(uw * scale)))
        t0 = time.perf_counter()
        for f in und:
            resize.apply(f)
        out[name] = {"read_ms": read_ms, "undistort_ms": und_ms,
                     "resize_ms": 1e3 * (time.perf_counter() - t0) / GEM_TIMED_FRAMES,
                     "source_hw": [h, w], "model_hw": [int(uh * scale), int(uw * scale)]}
    return out


def h2d_ms(groups: dict) -> float:
    """Device time of host-to-device copies in a profile's groups."""
    return sum(t for name, t in groups.items() if "HtoD" in name)


def profiled_steps(trainer, batches, dev) -> dict:
    """``training_step`` over ``batches`` under torch.profiler, each step
    synchronised: host ms per step (``step_ms`` the mean after the first,
    whose batch the loader had no step to prepare behind), device busy and
    host-to-device copy device time per step, the idle share over the whole
    run, and the launches of each step."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    launches, losses, times = [], [], []
    synchronize(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            before = launch_counts()
            losses.append(float(trainer.training_step(batch)["train_total_loss"]))
            synchronize(dev)
            times.append(time.perf_counter())
            after = launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
    n = len(launches)
    steps = [1e3 * (b - a) for a, b in zip([t0] + times[:-1], times)]
    groups, count = device_groups(prof, n)
    busy = sum(groups.values())
    assert all(math.isfinite(v) for v in losses), losses
    return {"step_ms": sum(steps[1:]) / max(n - 1, 1), "step_ms_each": steps,
            "device_busy_ms": busy, "idle_share": 1 - busy * n / sum(steps) if busy else None,
            "h2d_copy_device_ms": h2d_ms(groups), "kernels_per_step": count,
            "launches_per_step": launches, "losses": losses}


def copy_rates(nbytes: int) -> dict:
    """Host-to-device GB/s of one ``nbytes`` uint8 copy from pinned and from
    pageable memory (CUDA events): the yardstick for the copy device times
    the profiles report."""
    import torch

    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for kind, src in (("pinned", torch.ones(nbytes, dtype=torch.uint8, pin_memory=True)),
                      ("pageable", torch.ones(nbytes, dtype=torch.uint8))):
        ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), iters=5, warmup=1)
        out[kind] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
    del dst
    return out


GEM_AUDIO_RATE = 48000  # the dataset's AUDIO_FPS
GEM_AUDIO_TONES = {"left/GH010008.MP4": 11, "right/GH010009.MP4": 12}  # as the fixture's
GEM_AUDIO_FRONT = 0.25  # the audio epoch's front video scaling (its frames ride along)


def gem_walkers(data_root: Path) -> dict:
    """Every GPMF track of the recording through the native walker and the
    Python one: the same points and dilutions (exact); each walker's host
    seconds, and the index's seconds with each (``GEMDataset`` without
    video, gaze or audio, every subject; after one untimed index)."""
    import functools

    from routeformer_torch.io import dataset as dataset_module
    from routeformer_torch.io import gpmf
    from routeformer_torch.io.mp4 import read_gpmf_data

    out = {"tracks": 0, "points": 0, "native_s": 0.0, "python_s": 0.0}
    for path in sorted(data_root.glob("01GoPro/*/*/*.MP4")):
        data = read_gpmf_data(path)
        t0 = time.perf_counter()
        got = gpmf.build_gps_points(data)
        t1 = time.perf_counter()
        want = gpmf.build_gps_points(data, prefer_native=False)
        out["python_s"] += time.perf_counter() - t1
        out["native_s"] += t1 - t0
        key = [(p.latitude, p.longitude, p.altitude, p.speed, p.time) for p in got[0]]
        assert key == [(p.latitude, p.longitude, p.altitude, p.speed, p.time)
                       for p in want[0]] and got[1] == want[1], f"{path}: walkers differ"
        out["tracks"] += 1
        out["points"] += len(key)
    assert out["tracks"] == 2 * len(GEM_SUBJECTS), out
    for walker, prefer in (("warm-up", True), ("native", True), ("python", False)):
        real = dataset_module.build_gps_points
        dataset_module.build_gps_points = functools.partial(real, prefer_native=prefer)
        try:
            t0 = time.perf_counter()
            ds = dataset_module.GEMDataset(root=data_root, split=[s for s, _ in GEM_SUBJECTS],
                                           min_pci=None, with_video=False, with_gaze=False)
            out[f"index_s_{walker}"] = time.perf_counter() - t0
        finally:
            dataset_module.build_gps_points = real
        out[f"windows_{walker}"] = len(ds)
    assert out["windows_native"] == out["windows_python"], out
    return out


def aac_probe() -> str:
    """Whether the AAC shim (``csrc/audio.cpp`` over ffmpeg) builds and
    loads here: an information line, no check."""
    from routeformer_torch.io import native

    try:
        native.library("audio")
        return "the AAC shim built and loaded"
    except ImportError as e:
        return "the AAC shim is not available: " + str(e).splitlines()[0][:300]


def gem_audio_path(data_root: Path, geo: dict, dev, smi: str) -> dict:
    """Phase 7d's audio and GPMF part: PCM tracks added to the recording's
    nine videos (the fixture's tones, 48 kHz stereo, 1024 frames a chunk);
    the two GPMF walkers (``gem_walkers``); ``GEMDataset(with_audio=True)``
    (val subject, no GoPro video, the front video at GEM_AUDIO_FRONT)
    through the loader onto the card for one epoch: every placed batch the
    same bits as the numpy collate of its samples (the Python PCM decode),
    the three audio streams (B, T, 1) float32 at the dataset's frame
    counts."""
    from routeformer_torch.io.dataset import GEMDataset
    from routeformer_torch.io.gem_fixture import audio_tone, inject_pcm_audio_track
    from routeformer_torch.io.loader import DataLoader

    t_phase = time.perf_counter()
    out = {"aac": aac_probe()}
    log(f"info: {out['aac']}")
    t0 = time.perf_counter()
    for subject, _ in GEM_SUBJECTS:
        videos = {f"01GoPro/{subject}/{name}": tone for name, tone in GEM_AUDIO_TONES.items()}
        videos[f"02EyeTracker/{subject}/world.mp4"] = 13
        for name, tone in videos.items():
            inject_pcm_audio_track(data_root / name,
                                   audio_tone(gem_duration(geo, subject), GEM_AUDIO_RATE,
                                              tone),
                                   GEM_AUDIO_RATE)
    out["inject_s"] = time.perf_counter() - t0
    out["walkers"] = gem_walkers(data_root)
    ds = GEMDataset(root=data_root, split=["002"], min_pci=None, with_video=False,
                    with_audio=True, front_scaling_factor=GEM_AUDIO_FRONT,
                    video_dtype="uint8")
    loader = DataLoader(ds, batch_size=geo["batch"], shuffle=True, to_device=True, device=dev)
    epoch = loader_epoch(loader, 0)
    check_epoch_bits(loader, epoch)
    for batch in epoch["batches"]:
        for phase, count in (("train", ds.input_audio_frame_count),
                             ("target", ds.target_audio_frame_count)):
            for key in ("left_audio", "right_audio", "front_audio"):
                a = batch[phase][key]
                assert a.device.type == dev.type and a.dtype.is_floating_point, (phase, key)
                assert tuple(a.shape) == (geo["batch"], count, 1), (phase, key, a.shape)
    out["epoch"] = {"batches": len(epoch["batches"]), "seconds": epoch["seconds"],
                    "samples_per_s": epoch["samples_per_s"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"{smi}: GEM audio and GPMF {json.dumps(out)}")
    return out


def gem_data_path(results: dict, smi: str, dev=None, geo=None) -> dict:
    """Phase 7d. Returns the launches of the cold epoch's run and the
    first loader batch kept for phase 7i (``heatmap_batch``)."""
    import dataclasses
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.io.dataset import GEMDataset
    from routeformer_torch.io.loader import DataLoader, default_collate
    from routeformer_torch.train import CheckpointManager, MetricsLogger

    dev = torch.device("cuda") if dev is None else dev
    geo = dict(GEM if geo is None else geo)
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="gem_smoke_"))
    out = {"card": smi}
    try:
        data_root = tmp / "gem"
        data_root.mkdir()
        written = write_gem_recording(data_root, geo)
        geo = written.pop("geo")
        out["recording"] = written
        log(f"{smi}: GEM recording {json.dumps(written)}")

        # 2. Index, through the driver's build_data.
        env = dict({"DATASET": "GEM", "MODEL_SET": "flagship", "EPOCHS": "1",
                    "BATCH_SIZE": str(geo["batch"]), "ROUTEFORMER_DATASET_DIR": str(data_root),
                    "USE_MEMORY_CACHE": "1", "RESULTS_DIR": str(GEM_RUN_DIR)}, **geo["env"])
        s = dataclasses.replace(fc.Settings.from_env(env),
                                gopro_scaling_factor=geo["scaling"][0],
                                front_scaling_factor=geo["scaling"][1])
        shutil.rmtree(GEM_RUN_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        train, val = fc.build_data(s, device=dev)
        index_s = time.perf_counter() - t0
        ds_train, ds_val = train.dataset, val.dataset
        unfiltered = GEMDataset(root=data_root, split=["002"], min_pci=None, with_video=False,
                                with_gaze=False)
        pcis = [item["pci"] for item in unfiltered._indexer.values()]
        want = {"train": 2 * gem_windows(geo["train_duration_s"]),
                "val_unfiltered": gem_windows(geo["duration_s"]),
                "val": sum(p >= s.min_pci for p in pcis)}
        got = {"train": len(ds_train), "val_unfiltered": len(unfiltered), "val": len(ds_val)}
        out["index"] = {"seconds": index_s, "samples": got, "predicted": want}
        log(f"GEM index: {json.dumps(out['index'])}")
        assert got == want, out["index"]
        assert len(train) == 2 and len(val) >= 1, (len(train), len(val))

        # 3. The loader alone: two epochs, every batch's bits checked.
        loader = DataLoader(ds_train, batch_size=s.batch_size, shuffle=True, to_device=True,
                            h2d_dedup=True, device=dev)
        epochs = [loader_epoch(loader, 0), loader_epoch(loader, 1)]
        for e in epochs:
            check_epoch_bits(loader, e)
        kept = heatmap_batch(epochs[0]["batches"][0])
        distinct = check_distinct_keys(ds_train, epochs[0]["order"])
        out["loader"] = [{k: v for k, v in e.items() if k not in ("batches", "order")}
                         for e in epochs]
        out["distinct_keys_per_subject"] = distinct
        out["host_ms_per_frame"] = host_op_times(ds_train, data_root, geo)
        log(f"{smi}: GEM loader alone {json.dumps(out['loader'])}; host ms per frame "
            f"{json.dumps(out['host_ms_per_frame'])}; distinct keys {distinct}")
        numpy_batches = [default_collate([ds_train[int(i)] for i in idx])
                         for idx in epochs[0]["order"]]
        if dev.type == "cuda":
            batch_bytes = sum(v.nbytes for part in ("train", "target")
                              for v in numpy_batches[0][part].values())
            out["copy_rates"] = copy_rates(batch_bytes)
            log(f"{smi}: host-to-device copy of one batch ({batch_bytes} B) "
                f"{json.dumps(out['copy_rates'])}")
        del epochs, loader
        free_device()

        # 4. The driver's flagship on the recording: a cold epoch through
        # run_epochs on build_data's loaders (a cold frame store; samples
        # from the memory tier step 3 filled, val decoded here).
        set_fusion("1")
        trainer = fc.build_trainer(s, fc.build_models(s), dev)
        ckpt = CheckpointManager(s.results_dir / "checkpoints")
        metrics_logger = MetricsLogger(s.results_dir / "logs", experiment="smoke_gem")
        prepare = fc.make_prepare(None)  # no embedding cache: main() attaches no stage
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        if dev.type == "cuda":
            reset_peak()
        reset_counts()  # the main path: counts set to 0 just before, read just after
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            history = fc.run_epochs(trainer, ckpt, metrics_logger, train, val, prepare,
                                    epochs=1)
            synchronize(dev)
            epoch_s = time.perf_counter() - t0
        launches = launch_counts()
        metrics_logger.close()
        steps, evals = len(train), len(val) * MC_SAMPLES
        if dev.type == "cuda":
            for k in ("K1", "K2", "K3a", "K4"):
                expect = steps * RUN_PER_STEP[k] + evals * PER_EVAL_FORWARD[k]
                assert launches[k] == expect, f"GEM epoch: {k} {launches[k]}, not {expect}"
            assert steps * 16 <= launches["K3b"] <= steps * 24, launches
        values = [float(v) for v in history[0]["val"].values()]
        assert values and all(math.isfinite(v) for v in values), history
        groups, _ = device_groups(prof, steps + len(val))
        cold = {"epoch_s": epoch_s, "launches": launches,
                "peak_gib": peak_gib() if dev.type == "cuda" else None,
                "h2d_copy_device_ms_per_batch": h2d_ms(groups),
                "device_busy_ms_per_batch": sum(groups.values()),
                "frame_store": {"train": train.frame_store_stats(),
                                "val": val.frame_store_stats()},
                "bytes_copied_per_batch": (train.bytes_copied + val.bytes_copied
                                           + sum(v["bytes_shipped"] for d in (train, val)
                                                 for v in d.frame_store_stats().values()))
                / (steps + len(val)),
                "val_ade": float(history[0]["val"][f"val_{fc.FLAGSHIP}_ade"])}
        out["cold_epoch"] = cold
        log(f"{smi}: GEM cold epoch {json.dumps(cold)}")

        # The steps again, timed: the loader's pinned batches (warm frame
        # store), then the same batches as numpy through the trainer's
        # pageable copy on the consumer thread.
        if dev.type == "cuda":
            reset_peak()
        train.set_epoch(1)
        pinned = profiled_steps(trainer, train, dev)
        pinned["peak_gib"] = peak_gib() if dev.type == "cuda" else None
        pageable = profiled_steps(trainer, numpy_batches, dev)
        if dev.type == "cuda":
            for step in pinned["launches_per_step"] + pageable["launches_per_step"]:
                assert all(step[k] == RUN_PER_STEP[k] for k in RUN_PER_STEP), step
                assert step["K3b"] in PER_STEP["K3b"], step
        out["pinned_steps"], out["pageable_steps"] = pinned, pageable
        log(f"{smi}: GEM steps, loader (pinned, frame store) {json.dumps(pinned)}")
        log(f"{smi}: GEM steps, numpy (pageable) {json.dumps(pageable)}")
        del trainer, ckpt, train, val, numpy_batches
        free_device()

        # 5. Audio and the GPMF walkers on the same recording.
        out["audio"] = gem_audio_path(data_root, geo, dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(GEM_RUN_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    results["gem_data_path"] = out
    log(f"GEM data path phase: {out['phase_s']:.1f} s")
    return launches, kept


# --------------------------------------------------------------- phase 7e #

# The DR(eye)VE data path: sessions written by the port's writer
# (``io/dreyeve_fixture.py``), read by ``io/dataset_dreyeve.py``, loaded
# with the driver's placed split stage and trained on by the driver's
# flagship. 54 s sessions give 20 windows each: 01 and 02 (train) two
# batches of 16 (62 s gave three, cut for the smoke's time), 45 (val) one
# batch of 16 at MIN_PCI 20.
DREYEVE_SESSIONS = (1, 2, 45)
DREYEVE = {"duration_s": 54.0, "garmin_hw": (540, 960), "etg_hw": (720, 960),
           "scaling": (0.8, 1 / 3.0), "turn": 1.0, "batch": TRAIN_BATCH, "env": {}}
DREYEVE_RUN_DIR = ROOT / "build" / "smoke_dreyeve"
DREYEVE_TIMED_FRAMES = 12
REMAP_TOL = 1e-3  # card vs CPU remap of [0, 255] frames, absolute: f32 lerps, FMA or not
REMAP_H = ((0.98, 0.03, 12.5), (-0.02, 1.01, -4.0), (2e-5, -1e-5, 1.0))


def heatmap_batch(placed: dict) -> dict:
    """Phase 7i's input from a placed batch: its gaze and GPS and its first
    clip's front frames, on the host."""
    train = placed["train"]
    return {"gaze": train["gaze"].float().cpu().numpy(),
            "gps": train["gps"].float().cpu().numpy(),
            "frames": train["front_video"][0].cpu().numpy()}


def frame_gaze_pixels(gaze, n_frames: int, h: int, w: int):
    """(B, G, 2) normalised gaze (x from the left, y from the bottom) ->
    (B * n_frames, G // n_frames, 2) pixel points: each frame's samples."""
    import numpy as np

    b, g, _ = gaze.shape
    per = g // n_frames
    pts = gaze[:, :per * n_frames].reshape(b * n_frames, per, 2).astype(np.float64)
    return np.stack([pts[..., 0] * w, (1.0 - pts[..., 1]) * h], axis=-1)


def gaze_heatmaps(results: dict, smi: str, batches: dict, dev=None) -> None:
    """Phase 7i over ``batches`` (``{"gem": .., "dreyeve": ..}``, each a
    ``heatmap_batch`` of phases 7d and 7e). (``dev`` the CPU rehearses it.)"""
    import importlib.util

    import numpy as np
    import torch

    from routeformer_torch.ops import heatmap
    from routeformer_torch.visualize import gaze as vgaze

    t0 = time.perf_counter()
    dev = torch.device("cuda") if dev is None else dev
    out = {"card": smi}
    assert set(batches) == {"gem", "dreyeve"}, sorted(batches)
    for name, batch in batches.items():
        frames = batch["frames"]
        t, h, w, _ = frames.shape
        pts = frame_gaze_pixels(batch["gaze"], t, h, w)
        on_card = torch.from_numpy(pts.astype(np.float32)).to(dev)
        card = heatmap.rasterize_gaze_heatmap(on_card, h, w, HEATMAP_SIGMA)
        assert card.device.type == dev.type and card.shape == (len(pts), h, w)
        card = card.cpu().numpy()
        host = heatmap.rasterize_gaze_heatmap(pts, h, w, HEATMAP_SIGMA, device="cpu").numpy()
        nan_items = np.isnan(host).all(axis=(1, 2))
        assert np.array_equal(np.isnan(card), np.isnan(host)), name
        assert np.array_equal(np.isnan(host).any(axis=(1, 2)), nan_items), name
        finite = ~np.isnan(host)
        peak = float(np.abs(host[finite]).max()) if finite.any() else 0.0
        err = float(np.abs(card[finite] - host[finite]).max() / peak) if peak else 0.0
        ms = cuda_ms(lambda: heatmap.rasterize_gaze_heatmap(on_card, h, w, HEATMAP_SIGMA)) \
            if dev.type == "cuda" else None
        # The loaders' gaze carries no NaN (the datasets interpolate the
        # logs' gaps): a NaN sample in one frame, on both sides, makes that
        # frame's map NaN and leaves the others' bits.
        pts[1, 0] = np.nan
        on_card[1, 0] = float("nan")
        card_nan = heatmap.rasterize_gaze_heatmap(on_card, h, w, HEATMAP_SIGMA).cpu().numpy()
        host_nan = heatmap.rasterize_gaze_heatmap(pts, h, w, HEATMAP_SIGMA, device="cpu").numpy()
        keep = np.arange(len(pts)) != 1
        nan_witness = bool(np.isnan(card_nan[1]).all() and np.isnan(host_nan[1]).all()
                           and np.array_equal(card_nan[keep], card[keep], equal_nan=True)
                           and np.array_equal(host_nan[keep], host[keep], equal_nan=True))
        assert nan_witness, name
        per = pts.shape[1]
        clip_gaze = batch["gaze"][0, :per * t].reshape(t, per, 2)
        worst, near, near_diff = 0, 0, 0
        for i in range(min(HEATMAP_OVERLAY_FRAMES, t)):
            got = vgaze.overlay_heatmap_on_frame(frames[i], clip_gaze[i], HEATMAP_SIGMA,
                                                 device=dev)
            want = vgaze.overlay_heatmap_on_frame(frames[i], clip_gaze[i], HEATMAP_SIGMA,
                                                  device="cpu")
            diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
            edge = np.abs(host[i] - 0.2) <= HEATMAP_TOL  # the mask may fall either way
            worst = max(worst, int(diff[~edge].max(initial=0)))
            near += int(edge.sum())
            near_diff += int((diff[edge] > 1).sum())
        rec = {"frames": len(pts), "hw": [h, w], "samples_per_frame": per,
               "nan_frames": int(nan_items.sum()), "nan_witness": nan_witness,
               "max_err": err, "ms_per_batch": ms,
               "overlay_max_level_diff": worst, "overlay_pixels_at_mask_edge": near,
               "overlay_edge_pixels_differing": near_diff}
        log(f"{smi}: gaze heatmaps {name}: {json.dumps(rec)}")
        assert err <= HEATMAP_TOL and worst <= 1, (name, rec)
        out[name] = rec
    if importlib.util.find_spec("matplotlib") is None:
        out["matplotlib"] = "not importable here: plot_gps_data_on_map not run"
    else:
        from routeformer_torch.visualize import plot_gps_data_on_map, render_figure_to_image

        import matplotlib.pyplot as plt

        gps = batches["gem"]["gps"][0]
        fig = plot_gps_data_on_map({"x": gps[:, 0], "y": gps[:, 1]}, offset=5.0,
                                   figure_kwargs={"figsize": (4, 4), "frameon": False}
                                   ).get_figure()
        out["matplotlib"] = f"rendered a trajectory: {render_figure_to_image(fig).shape}"
        plt.close(fig)
    log(f"information: matplotlib {out['matplotlib']}")
    log(f"gaze heatmap phase: {time.perf_counter() - t0:.1f} s")
    results["gaze_heatmaps"] = out


def dreyeve_windows(duration_s: float) -> int:
    """Windows of one session: starts every 60 rows while 420 rows fit."""
    n = int(duration_s * 30)
    return len(range(0, n - 420, 60))


def write_dreyeve_recording(root: Path, geo: dict) -> dict:
    """The three sessions (windows' frames only), halving the duration
    while the disk cannot hold them twice over."""
    from routeformer_torch.io.dreyeve_fixture import build_dreyeve_fixture

    frame_bytes = 3 * (math.prod(geo["garmin_hw"]) + math.prod(geo["etg_hw"]))
    need = len(DREYEVE_SESSIONS) * int(geo["duration_s"] * 5) * frame_bytes
    free = shutil.disk_usage(root).free
    cuts = []
    while 2 * need > free and geo["duration_s"] > 30:
        geo = dict(geo, duration_s=geo["duration_s"] / 2)
        need //= 2
        cuts.append(f"duration halved to {geo['duration_s']} s: {free / 1e9:.1f} GB free")
    t0 = time.perf_counter()
    build_dreyeve_fixture(root, session_ids=DREYEVE_SESSIONS, duration_s=geo["duration_s"],
                          garmin_hw=geo["garmin_hw"], etg_hw=geo["etg_hw"], turn=geo["turn"],
                          sparse=True)
    nbytes = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    return {"geo": geo, "seconds": time.perf_counter() - t0, "bytes": nbytes,
            "disk_free_bytes": free, "cuts": cuts}


def check_split_views(batch: dict) -> None:
    """Each phase's halves are views of one placed tensor: one storage,
    both inside it, the right half starting half a row in."""
    for phase in ("train", "target"):
        left, right = batch[phase]["left_video"], batch[phase]["right_video"]
        storage = left.untyped_storage()
        assert storage.data_ptr() == right.untyped_storage().data_ptr(), f"{phase}: copies"
        end = storage.data_ptr() + storage.nbytes()
        for half in (left, right):
            assert storage.data_ptr() <= half.data_ptr() < end, f"{phase}: outside the storage"
        assert right.data_ptr() - left.data_ptr() == left.shape[3] * left.shape[4], phase


def dreyeve_host_times(dataset, root: Path, geo: dict) -> dict:
    """Host ms a source frame, one thread: the frame file's read and the
    ``INTER_AREA`` scaling, for the garmin and the ETG view."""
    from routeformer_torch.io.frames import read_frame
    from routeformer_torch.ops.image import resize_area

    ids = [int(i) for i in dataset.metadata[DREYEVE_SESSIONS[0]]["frame_gar"][
        : 6 * DREYEVE_TIMED_FRAMES: 6]]
    out = {}
    for name, folder, scale in (("garmin", "video_garmin_frames", geo["scaling"][0]),
                                ("etg", "video_etg_frames", geo["scaling"][1])):
        paths = [root / f"{DREYEVE_SESSIONS[0]:02d}" / folder / f"{i:06d}.jpg" for i in ids]
        t0 = time.perf_counter()
        frames = [read_frame(p) for p in paths]
        read_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
        t0 = time.perf_counter()
        scaled = [resize_area(f, scale) for f in frames]
        out[name] = {"read_ms": read_ms,
                     "inter_area_ms": 1e3 * (time.perf_counter() - t0) / len(paths),
                     "source_hw": list(frames[0].shape[:2]),
                     "model_hw": list(scaled[0].shape[:2])}
    return out


def remap_check(dataset, dev, smi: str) -> dict:
    """``ops/image.remap`` of 16 fixture garmin frames at the stitcher's
    canvas grid for ``REMAP_H`` (source coordinates in the frame, border
    clamped): the card against the CPU, and the card's time."""
    import numpy as np
    import torch

    from routeformer_torch.ops.image import remap

    sample = dataset[0]["train"]["left_video"][:16]
    frames = torch.from_numpy(np.ascontiguousarray(sample))
    h, w = frames.shape[1:3]
    hinv = np.linalg.inv(np.array(REMAP_H))
    ys, xs = np.mgrid[0:h, 0:2 * w].astype(np.float64)
    coords = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ hinv.T
    grid = torch.from_numpy((coords[..., :2] / coords[..., 2:3]).astype(np.float32))
    want = remap(frames, grid)
    frames_d, grid_d = frames.to(dev), grid.to(dev)
    got = remap(frames_d, grid_d)
    err = float((got.cpu() - want).abs().max())
    ms = cuda_ms(lambda: remap(frames_d, grid_d)) if dev.type == "cuda" else None
    out = {"shape": list(got.shape), "max_abs_err": err, "tol": REMAP_TOL, "ms": ms,
           "card": smi}
    assert err <= REMAP_TOL, out
    return out


def dreyeve_data_path(results: dict, smi: str, dev=None, geo=None) -> dict:
    """Phase 7e. Returns the launches of the cold epoch's run and the
    first loader batch kept for phase 7i (``heatmap_batch``)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.io.dataset_dreyeve import DreyeveDataset
    from routeformer_torch.io.frame_store import hash_frames
    from routeformer_torch.io.loader import DataLoader, default_collate
    from routeformer_torch.train import CheckpointManager, MetricsLogger
    from routeformer_torch.train.trainer import maybe_split_video

    dev = torch.device("cuda") if dev is None else dev
    geo = dict(DREYEVE if geo is None else geo)
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="dreyeve_smoke_"))
    out = {"card": smi}
    try:
        data_root = tmp / "dreyeve"
        data_root.mkdir()
        written = write_dreyeve_recording(data_root, geo)
        geo = written.pop("geo")
        out["recording"] = written
        log(f"{smi}: DR(eye)VE recording {json.dumps(written)}")

        # Index, through the driver's build_data.
        env = {"DATASET": "DREYEVE", "MODEL_SET": "flagship", "EPOCHS": "1",
               "BATCH_SIZE": str(geo["batch"]), "DREYEVE_DATASET_DIR": str(data_root),
               "VIDEO_DTYPE": "uint8", "H2D_DEDUP": "1", "ENABLE_LEFT_VIDEO_SPLIT": "1",
               "USE_MEMORY_CACHE": "1", "RESULTS_DIR": str(DREYEVE_RUN_DIR), **geo["env"]}
        s = dataclasses.replace(fc.Settings.from_env(env),
                                gopro_scaling_factor=geo["scaling"][0],
                                front_scaling_factor=geo["scaling"][1])
        assert s.split_video, "the driver does not split the DR(eye)VE view"
        shutil.rmtree(DREYEVE_RUN_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        train, val = fc.build_data(s, device=dev)
        index_s = time.perf_counter() - t0
        prepare = fc.make_prepare(None, split_video=True)
        fc.attach_prepare(s, (train, val), prepare, device_memo=False, host_stage=False)
        ds_train, ds_val = train.dataset, val.dataset
        unfiltered = DreyeveDataset(data_root, split=[DREYEVE_SESSIONS[2]], min_pci=None,
                                    with_video=False)
        per_session = {sid: sum(e["session_id"] == sid for e in ds_train.data)
                       for sid in DREYEVE_SESSIONS[:2]}
        n = dreyeve_windows(geo["duration_s"])
        want = {"per_session": {sid: n for sid in DREYEVE_SESSIONS[:2]},
                "val_unfiltered": n,
                "val": sum(e["pci"] >= s.min_pci for e in unfiltered.data)}
        got = {"per_session": per_session, "val_unfiltered": len(unfiltered.data),
               "val": len(ds_val)}
        out["index"] = {"seconds": index_s, "samples": got, "predicted": want}
        log(f"DR(eye)VE index: {json.dumps(out['index'], default=str)}")
        assert got == want, out["index"]
        assert len(train) == 2 and len(val) >= 1, (len(train), len(val))

        # The loader alone, with the driver's placed split: two epochs.
        loader = DataLoader(ds_train, batch_size=s.batch_size, shuffle=True, to_device=True,
                            h2d_dedup=True, device=dev)
        loader.set_placed_stage(prepare)
        epochs = [loader_epoch(loader, 0), loader_epoch(loader, 1)]
        for e in epochs:
            for b, (placed, idx) in enumerate(zip(e["batches"], e["order"])):
                check_split_views(placed)
                want_batch = maybe_split_video(
                    default_collate([ds_train[int(i)] for i in idx]), True)
                same_bits(placed, want_batch, f"batch {b}")
        kept = heatmap_batch(epochs[0]["batches"][0])
        keys_of = {}
        for i in (int(i) for idx in epochs[0]["order"] for i in idx):
            sample, entry = ds_train.get_with_info(i)
            for stream in ("left_video", "front_video"):
                frames = np.concatenate([sample["train"][stream], sample["target"][stream]])
                keys = hash_frames(np.ascontiguousarray(frames))
                assert len(set(keys)) == len(keys), f"sample {i} {stream}: repeated frames"
                keys_of.setdefault(entry["session_id"], set()).update(keys)
        assert not keys_of[DREYEVE_SESSIONS[0]] & keys_of[DREYEVE_SESSIONS[1]], "shared frames"
        out["distinct_keys_per_session"] = {k: len(v) for k, v in keys_of.items()}
        out["loader"] = [{k: v for k, v in e.items() if k not in ("batches", "order")}
                         for e in epochs]
        out["frame_memo"] = {"hits": ds_train._frame_memo.hits,
                             "misses": ds_train._frame_memo.misses}
        out["host_ms_per_frame"] = dreyeve_host_times(ds_train, data_root, geo)
        log(f"{smi}: DR(eye)VE loader alone {json.dumps(out['loader'])}; host ms per frame "
            f"{json.dumps(out['host_ms_per_frame'])}; frame memo {out['frame_memo']}; "
            f"distinct keys {out['distinct_keys_per_session']}")
        del epochs, loader
        free_device()

        # The driver's flagship: a cold epoch through run_epochs on
        # build_data's loaders (cold frame store; train samples from the
        # memory tier filled above, val decoded here).
        set_fusion("1")
        trainer = fc.build_trainer(s, fc.build_models(s), dev)
        ckpt = CheckpointManager(s.results_dir / "checkpoints")
        metrics_logger = MetricsLogger(s.results_dir / "logs", experiment="smoke_dreyeve")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        if dev.type == "cuda":
            reset_peak()
        reset_counts()  # the main path: counts set to 0 just before, read just after
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            history = fc.run_epochs(trainer, ckpt, metrics_logger, train, val, prepare,
                                    epochs=1)
            synchronize(dev)
            epoch_s = time.perf_counter() - t0
        launches = launch_counts()
        metrics_logger.close()
        steps, evals = len(train), len(val) * MC_SAMPLES
        if dev.type == "cuda":
            for k in ("K1", "K2", "K3a", "K4"):
                expect = steps * RUN_PER_STEP[k] + evals * PER_EVAL_FORWARD[k]
                assert launches[k] == expect, f"DR(eye)VE epoch: {k} {launches[k]}, not {expect}"
            assert steps * 16 <= launches["K3b"] <= steps * 24, launches
        values = [float(v) for v in history[0]["val"].values()]
        assert values and all(math.isfinite(v) for v in values), history
        groups, _ = device_groups(prof, steps + len(val))
        out["cold_epoch"] = {
            "epoch_s": epoch_s, "launches": launches,
            "peak_gib": peak_gib() if dev.type == "cuda" else None,
            "h2d_copy_device_ms_per_batch": h2d_ms(groups),
            "device_busy_ms_per_batch": sum(groups.values()),
            "frame_store": {"train": train.frame_store_stats(), "val": val.frame_store_stats()},
            "val_ade": float(history[0]["val"][f"val_{fc.FLAGSHIP}_ade"])}
        log(f"{smi}: DR(eye)VE cold epoch {json.dumps(out['cold_epoch'])}")

        if dev.type == "cuda":
            reset_peak()
        train.set_epoch(1)
        steps_run = profiled_steps(trainer, train, dev)
        steps_run["peak_gib"] = peak_gib() if dev.type == "cuda" else None
        if dev.type == "cuda":
            for step in steps_run["launches_per_step"]:
                assert all(step[k] == RUN_PER_STEP[k] for k in RUN_PER_STEP), step
                assert step["K3b"] in PER_STEP["K3b"], step
        out["steps"] = steps_run
        log(f"{smi}: DR(eye)VE steps on the loader's batches {json.dumps(steps_run)}")
        del trainer, ckpt, train, val
        free_device()
        out["remap"] = remap_check(ds_train, dev, smi)
        log(f"{smi}: remap card vs CPU {json.dumps(out['remap'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(DREYEVE_RUN_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    results["dreyeve_data_path"] = out
    log(f"DR(eye)VE data path phase: {out['phase_s']:.1f} s")
    return launches, kept


# --------------------------------------------------------------- phase 7g #

# The zoo's remainder at the flagship's widths (GEM geometry, batch 16):
# (GPS backbone, video backbone) of ``flagship.GPS_VARIANTS``/``VIDEO_VARIANTS``.
ZOO_VARIANTS = (("Autoformer", "SwinV2"), ("FEDformer-Fourier", "SwinV2"),
                ("FEDformer-Wavelets", "SwinV2"), ("Informer", "InverseForm"))
ZOO_BATCH = 16
ZOO_TIMED_STEPS = 2  # train steps timed after one warm step, 7g and 7h alike
# The variant exported and held to its live forward (phase 7g): FEDformer's
# spectral products are real, so that ``torch.export`` takes them.
ZOO_EXPORTS = ("FEDformer-Fourier",)
# The variants whose batch-1 card forward is held against the CPU plain
# forward (phase 7g; SwinV2's stage 2 cut to its first pair on both sides):
# FEDformer's, whose spectral products are written in real arithmetic.
ZOO_CPU_VARIANTS = ("FEDformer-Fourier", "FEDformer-Wavelets")
# The variants whose GPS backbone alone is held against the CPU on the
# card's own backbone input (``gps_on_the_cards_input``, as PatchTST's
# witness; no CPU SwinV2 forward).
ZOO_GPS_CPU_VARIANTS = ("Autoformer",)
# InverseForm reads its frames raw, at their own size (the SwinV2 variants
# resize every frame to 256), so its variant runs on frames at the driver's
# real GEM geometry, phase 7d's scaled sizes, in the loader's uint8
# (``VIDEO_DTYPE``): the GoPro pair's crop (216, 153), the world camera's
# (326, 324).
GEM_MODEL_HW = {"left_video": (216, 153), "right_video": (216, 153), "front_video": (326, 324)}
# Launches per train step and per batch-16 eval forward (the fused stack):
# the tanh SwinV2's 24 blocks run K1 (one K2 inside each) per backbone
# pass; InverseForm's HRNet-16 runs no kernel of the port; the three
# Perceive stacks run K3a per layer, K3b per trained layer.
ZOO_PER_STEP = {"SwinV2": PER_STEP,
                "InverseForm": dict(PER_STEP, K1=(0,), K2=(0,))}
ZOO_PER_FORWARD = {"SwinV2": {"K1": 24, "K2": 24, "K3a": 24, "K3b": 0, "K4": 0},
                   "InverseForm": {"K1": 0, "K2": 0, "K3a": 24, "K3b": 0, "K4": 0}}


def zoo_name(gps: str, video: str) -> str:
    return f"{gps}_{video}"


def place_numpy(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def zoo_batch(seed: int, video: str) -> dict:
    """A batch-16 synthetic GEM clip (numpy): frames at (54, 96) for the
    SwinV2 variants, at ``GEM_MODEL_HW`` in uint8 for InverseForm."""
    import numpy as np

    import routeformer_torch as rt
    from routeformer_torch.io.synthetic import synthetic_batch_numpy

    cfg = rt.flagship_config()
    g = cfg.gps_backbone_config
    kw = dict(seq_len=g.seq_len, pred_len=g.pred_len, fps=cfg.output_fps, with_video=True,
              with_gaze=True)
    if video != "InverseForm":
        return synthetic_batch_numpy(seed, ZOO_BATCH, frame_hw=(54, 96), **kw)
    by_hw = {hw: synthetic_batch_numpy(seed, ZOO_BATCH, frame_hw=hw, **kw)
             for hw in set(GEM_MODEL_HW.values())}
    out = by_hw[GEM_MODEL_HW["left_video"]]
    for part in ("train", "target"):
        for key, hw in GEM_MODEL_HW.items():
            out[part][key] = np.round(by_hw[hw][part][key] * 255).astype(np.uint8)
    return out


def zoo_remainder(results: dict, smi: str):
    """Phase 7g: each variant's batch-16 serving, three train steps (the
    mean time of two after a warm one) and a profiled one; for
    ``ZOO_CPU_VARIANTS`` its batch-1 card forward and a CPU copy go into
    the returned ``CardVsCpu`` (started here, checked in phase 7h before its
    timed steps)."""
    import torch

    import routeformer_torch as rt

    set_fusion("1")
    g = rt.flagship_config().gps_backbone_config
    data = {video: zoo_batch(5, video) for video in {v for _, v in ZOO_VARIANTS}}
    card_cpu = CardVsCpu(data["SwinV2"]["train"], place_numpy)
    out, launches = {}, {}
    for gps, video in ZOO_VARIANTS:
        name = zoo_name(gps, video)
        request = data[video]["train"]
        inp, tgt = place_numpy(request), place_numpy(data[video]["target"])
        t0 = time.perf_counter()
        model, optimizer, step = rt.build_flagship_training(seed=0, gps=gps, video=video)
        optimizer.count = TRAIN_EPOCH  # past the warmup's rate 0
        rec = {"parameters": sum(p.numel() for p in model.parameters()),
               "build_s": time.perf_counter() - t0}
        if gps in ZOO_CPU_VARIANTS:  # the CPU copy runs 8 of SwinV2's 24 blocks, as the card's
            card_cpu.card(name, model, depth=1, batch=request)
        if gps in ZOO_GPS_CPU_VARIANTS:
            rec["gps_card_vs_cpu"] = gps_on_the_cards_input(model, request)
        serving = rt.ServingModel(model, torch.device("cuda"))
        reset_counts()  # the variant's serving path: counts from 0 just before
        pred, dense = serving(request)
        torch.cuda.synchronize()
        per_forward = launch_counts()
        assert pred.shape == (ZOO_BATCH, g.pred_len, 2), pred.shape
        assert torch.isfinite(pred).all() and torch.isfinite(dense).all(), name
        assert per_forward == ZOO_PER_FORWARD[video], (name, per_forward)
        reset_peak()
        rec["request_ms_b16"] = cuda_ms(lambda: serving(request), iters=2, warmup=1)
        rec["request_peak_gib"] = peak_gib()
        if gps in ZOO_EXPORTS:
            rec["export"] = zoo_export(model, serving, {k: v[:1] for k, v in request.items()})

        model.train()
        before = params_of(model)
        reset_counts()  # the variant's train path: counts from 0 just before
        per_step, metrics, times = [], [], []
        reset_peak()
        for _ in range(1 + ZOO_TIMED_STEPS):
            counts = launch_counts()
            times.append(event_ms(lambda: metrics.append(
                {k: v.item() for k, v in step(inp, tgt, TRAIN_EPOCH).items()})))
            per_step.append({k: v - counts[k] for k, v in launch_counts().items()})
        rec["step_peak_gib"] = peak_gib()
        rec["step_ms"] = sum(times[1:]) / ZOO_TIMED_STEPS  # after the warm step
        rec["step_ms_each"] = times
        launches[name] = per_step
        want = ZOO_PER_STEP[video]
        assert all(c[k] in want[k] for c in per_step for k in want), (name, per_step)
        assert all(math.isfinite(v) for m in metrics for v in m.values()), (name, metrics)
        moved = {"backbone": 0.0, "rest": 0.0}
        for n, p in model.named_parameters():
            key = "backbone" if "video_backbone" in n else "rest"
            moved[key] = max(moved[key], (p.detach() - before[n]).abs().max().item())
        del before
        assert moved["rest"] > 0.0 and moved["backbone"] < 1e-7, (name, moved)
        prof = profile_step(lambda: step(inp, tgt, TRAIN_EPOCH), rec["step_ms"], {}, name)
        rec.update(busy_ms_per_step=prof["device_busy_ms_per_step"],
                   idle_share=prof["idle_share"], launches_per_step=per_step[-1],
                   launches_per_forward=per_forward, loss=metrics[0].get("loss"), moved=moved,
                   frames_hw={k: list(v.shape[2:4]) for k, v in request.items()
                              if k.endswith("_video")})
        out[name] = rec
        log(f"{smi}: zoo {name} " + json.dumps(rec))
        del model, optimizer, step, serving, inp, tgt
        free_device()
    card_cpu.start()
    results["zoo"] = out
    return card_cpu, launches


def gps_on_the_cards_input(model, batch: dict) -> dict:
    """The card's batch-1 eval forward of ``batch``'s first clip (moved to
    its last fix, ``CardVsCpu._one``) with its GPS backbone's input and
    output captured, and the backbone rebuilt on the CPU from the same
    weights on that input: max|diff|/max|cpu| of the backbone's output,
    within ``PRED_TOL``."""
    import torch

    seen = {}

    def capture(_module, args, out):
        seen["x"], seen["y"] = args[0].detach().float().cpu(), out.detach().float().cpu()

    gps = model.gps_backbone
    was_training = model.training
    model.eval()
    handle = gps.register_forward_hook(capture)
    try:
        with torch.inference_mode():
            model(place_numpy(CardVsCpu._one(batch)))
    finally:
        handle.remove()
        model.train(was_training)
    cpu = type(gps)(model.configs.gps_backbone_config)
    cpu.load_state_dict({k: v.cpu() for k, v in gps.state_dict().items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu.eval()(seen["x"])
    rec = {"gps_backbone_vs_cpu": rel_err(seen["y"], want), "cpu_s": time.perf_counter() - t0,
           "input_shape": list(seen["x"].shape)}
    assert rec["gps_backbone_vs_cpu"] <= PRED_TOL, rec
    return rec


def zoo_export(model, serving, batch: dict) -> dict:
    """The variant exported (``export_model``) and reloaded from its bytes
    (``ExportedModel``): its batch-1 prediction against the live
    ``ServingModel``'s, the same bits, else within EXPORT_TOL of its max
    with the first differing op named; the launches of both forwards,
    counted from 0 just before each and read just after, equal."""
    import torch

    import routeformer_torch as rt
    from routeformer_torch.serve import ExportedModel, _eval_forward

    reset_counts()
    want = serving(batch)[0]
    torch.cuda.synchronize()
    live = launch_counts()
    t0 = time.perf_counter()
    data = rt.export_model(model, batch)
    exported = ExportedModel(data, _eval_forward(model)[1])
    export_s = time.perf_counter() - t0
    reset_counts()
    got = exported(batch)
    torch.cuda.synchronize()
    per = launch_counts()
    row = {"export_and_load_s": export_s, "artifact_bytes": len(data), "launches_live": live,
           "launches_exported": per, "same_bits": bool(torch.equal(got, want)),
           "max_rel_err": rel_err(got, want)}
    if not row["same_bits"]:
        row["first_difference"] = name_export_difference(model, exported, batch)
    assert got.shape == want.shape and torch.isfinite(got).all(), row
    assert per == live, row
    assert row["same_bits"] or row["max_rel_err"] <= EXPORT_TOL, row
    return row


# --------------------------------------------------------------- phase 7h #

# Backbone training (``train_backbone=True``): (name, video variant, the
# kernel its backbone runs, the Perceive stacks' path, the batches to start
# from without and with remat). DinoV2's frame encoder sees 1370 tokens,
# above K3b's 208: its stacks take K3a with the recompute backward
# (``hybrid``). A variant halves its batch until a step fits; DinoV2 starts
# at 2 and 4 (16, 8 and 4 did not fit without remat, 16 and 8 with it), and
# goes first, so that its CPU reference, the longest, starts first.
BACKBONE_VARIANTS = (("dinov2", "DinoV2", "K4", "hybrid", (2, 4)),
                     ("swinv2_tanh", "SwinV2", "K1", "1", (ZOO_BATCH, ZOO_BATCH)),
                     ("swinv2_exact", "SwinV2-exact", "K2", "1", (ZOO_BATCH, ZOO_BATCH)))
# Remat on against off on the card, the same weights, batch and augment
# draws, dropout off: the loss to 1e-5 relative, each gradient to 1e-3 of
# the largest (cuDNN's convolution backward is not deterministic, and a
# bf16 block recomputed in the backward may round one sum differently; the
# H100 read 1.3e-4 to 1.6e-4 for SwinV2 and 2e-5 for DinoV2, same losses).
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-5, 1e-3
# The first step's loss on the card against the CPU plain step (batch 1,
# the depth cut below on both, the augment draws shared, dropout off):
# relative, the bf16 backbone's limit (PRED_TOL).
BACKBONE_LOSS_TOL = PRED_TOL
# The CPU comparison's depth: SwinV2's stage 2 keeps its first pair (8 of
# 24 blocks). DinoV2's CPU loss (58.9 s at its first block) is left out for
# the smoke's time: phase 5c holds its forward against the CPU.
BACKBONE_CPU_DEPTH = 1
BACKBONE_CPU_VARIANTS = ("swinv2_tanh", "swinv2_exact")


class ThreadDraws:
    """``photometric_augment`` for phase 7h: a thread that set
    ``local.draws`` (a ``SharedDraws``) gets those draws, any other the real
    augment, so the CPU references can run beside the card's steps."""

    def __init__(self, real):
        import threading

        self.real, self.local = real, threading.local()

    def __call__(self, images, generator=None, **kwargs):
        shared = getattr(self.local, "draws", None)
        if shared is None:
            return self.real(images, generator, **kwargs)
        return shared(images, **kwargs)


class SharedDraws:
    """``photometric_augment`` with draws made on the CPU from a generator
    seeded per call (``seed`` + the call's index) and moved to the frames'
    device: the card and the CPU augment alike."""

    def __init__(self, seed: int):
        self.seed, self.calls = seed, 0

    def __call__(self, images, generator=None, **kwargs):
        import torch

        from routeformer_torch.ops import augment

        n, h, w, _ = images.shape
        gen = torch.Generator().manual_seed(self.seed + self.calls)
        self.calls += 1
        draws = augment.draw_augment(n, h, w, gen, **kwargs)
        return augment.apply_augment(images, {k: v.to(images.device) for k, v in draws.items()})


def step_loss(model, inp, tgt, draws_seed: int, backward: bool):
    """The train-mode loss (and gradients) with the augment's draws shared
    (``ThreadDraws`` installed)."""
    from routeformer_torch.ops import augment
    from routeformer_torch.train import TrainingLosses, routeformer_training_loss

    local = augment.photometric_augment.local
    local.draws = SharedDraws(draws_seed)
    try:
        model.zero_grad(set_to_none=True)
        loss, _ = routeformer_training_loss(model, inp, tgt, TRAIN_EPOCH,
                                            TrainingLosses.from_config(model.configs))
        if backward:
            loss.backward()
    finally:
        local.draws = None
    return loss.detach().float().cpu()


def cpu_step_loss(cpu, b_in, b_tgt) -> dict:
    """The CPU plain step's first loss (a worker thread's job)."""
    import torch

    t0 = time.perf_counter()
    with torch.no_grad():
        loss = step_loss(cpu, b_in, b_tgt, 100, backward=False)
    return {"loss": loss, "cpu_s": time.perf_counter() - t0}


def fitting_batch(fn, start: int):
    """``fn(batch)`` at ``start`` rows, halved while it does not fit."""
    import torch

    size = start
    while True:
        try:
            return size, fn(size)
        except torch.cuda.OutOfMemoryError:
            log(f"batch {size} does not fit in device memory")
            free_device()
            size //= 2
            assert size >= 1, "no batch fits"


def backbone_training(results: dict, smi: str, card_cpu) -> dict:
    """Phase 7h: ``build_flagship_training(train_backbone=True)`` per
    backbone variant. First, beside the CPU references (7g's and the
    first-step losses, in worker threads): the card's depth-cut loss for
    the CPU comparison and remat on against off. Then, with the CPU
    references joined and checked: optimizer steps each way, timed."""
    from concurrent.futures import ThreadPoolExecutor

    from routeformer_torch.ops import augment

    real = augment.photometric_augment
    augment.photometric_augment = ThreadDraws(real)
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return _backbone_training(results, smi, card_cpu, pool)
    finally:
        pool.shutdown(wait=True)
        augment.photometric_augment = real
        set_fusion("1")


def backbone_variant(video: str):
    """``(model, optimizer, step)`` with ``train_backbone=True``, dropout
    off, in train mode; the backbone's parameters are the optimizer's
    ``video_backbone`` group."""
    import routeformer_torch as rt

    model, optimizer, step = rt.build_flagship_training(seed=0, video=video,
                                                        train_backbone=True)
    optimizer.count = TRAIN_EPOCH
    quiet(model)
    model.train()
    group = {id(p) for p in optimizer.opt.param_groups[1]["params"]}
    assert group == {id(p) for p in model.video_backbone.parameters()}, "video_backbone group"
    return model, optimizer, step


def _backbone_training(results: dict, smi: str, card_cpu, pool) -> dict:
    import torch

    inp, tgt = train_batches(21)
    out, launches, cpu_jobs = {}, {}, []

    def rows(batch, n):
        return {k: v[:n] for k, v in batch.items()}

    for name, video, kernel, fusion, start in BACKBONE_VARIANTS:
        set_fusion(fusion)
        t0 = time.perf_counter()
        model, optimizer, step = backbone_variant(video)
        bb = model.video_backbone
        rec = {"build_s": time.perf_counter() - t0}

        if name in BACKBONE_CPU_VARIANTS:  # the card's batch-1 loss, depth cut, for the CPU
            restore = cut_depth(model, BACKBONE_CPU_DEPTH)
            card_loss = step_loss(model, rows(inp, 1), rows(tgt, 1), 100, backward=False)
            restore()
            cpu = rebuild_on_cpu(model).train()
            quiet(cpu)
            cut_depth(cpu, BACKBONE_CPU_DEPTH)
            cpu_jobs.append((name, card_loss, pool.submit(
                cpu_step_loss, cpu, {k: v[:1].cpu() for k, v in inp.items()},
                {k: v[:1].cpu() for k, v in tgt.items()})))
            del cpu

        # remat off against on: the same batch, weights and draws
        def grads_at(remat):
            def run(size):
                bb.configs.remat = remat
                reset_counts()
                loss = step_loss(model, rows(inp, size), rows(tgt, size), 200, backward=True)
                torch.cuda.synchronize()
                return loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()
                              if p.grad is not None}, launch_counts()
            return run

        size, (loss_off, g_off, counts_off) = fitting_batch(grads_at(False), start[0])
        loss_on, g_on, counts_on = grads_at(True)(size)
        scale = max(float(g.abs().max()) for g in g_off.values())
        grad_gap = max(float((g_on[n] - g).abs().max()) for n, g in g_off.items()) / scale
        loss_gap = abs(float(loss_on - loss_off)) / abs(float(loss_off))
        bb_grads = [g_off[n] for n, _ in model.named_parameters()
                    if n.startswith("video_backbone.") and n in g_off]
        bb_norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in bb_grads])))
        assert len(bb_grads) == len(list(bb.parameters())), "backbone parameters without grad"
        assert math.isfinite(bb_norm) and bb_norm > 0, bb_norm
        assert loss_gap <= REMAT_LOSS_TOL and grad_gap <= REMAT_GRAD_TOL, (loss_gap, grad_gap)
        assert counts_on[kernel] > counts_off[kernel], (counts_on, counts_off)
        del g_off, g_on
        rec.update(compare_batch=size, remat_loss_gap=loss_gap, remat_grad_gap=grad_gap,
                   backbone_grad_norm=bb_norm, launches_loss_and_backward_remat_off=counts_off,
                   launches_loss_and_backward_remat_on=counts_on)
        out[name] = rec
        del model, optimizer, step, bb
        free_device()

    # the CPU references joined and checked before any step is timed
    zoo_errs = card_cpu.check()
    results["zoo_card_vs_cpu"] = zoo_errs
    log(f"zoo card vs CPU (batch 1, max|diff|/max|cpu|): {json.dumps(zoo_errs)}")
    for name, card_loss, job in cpu_jobs:
        rec = job.result()
        cpu_loss = rec["loss"]
        gap = abs(float(card_loss - cpu_loss)) / abs(float(cpu_loss))
        out[name].update(first_loss_card=float(card_loss), first_loss_cpu=float(cpu_loss),
                         first_loss_gap=gap, cpu_s=rec["cpu_s"])
        log(f"{name}: first-step loss card {float(card_loss):.6f} CPU {float(cpu_loss):.6f} "
            f"(relative {gap:.3e})")
        assert gap <= BACKBONE_LOSS_TOL, (name, gap)

    # optimizer steps each way at the largest batch that fits: one warm
    # step, then ZOO_TIMED_STEPS timed
    for name, video, kernel, fusion, start in BACKBONE_VARIANTS:
        set_fusion(fusion)
        model, optimizer, step = backbone_variant(video)
        bb = model.video_backbone
        rec = out[name]
        for remat in (False, True):
            bb.configs.remat = remat
            free_device()

            def steps(n):
                b_in, b_tgt = rows(inp, n), rows(tgt, n)
                before = {k: p.detach().clone() for k, p in bb.named_parameters()}
                per, metrics, times = [], [], []
                reset_peak()
                for _ in range(1 + ZOO_TIMED_STEPS):
                    reset_counts()
                    times.append(event_ms(lambda: metrics.append(step(b_in, b_tgt,
                                                                      TRAIN_EPOCH))))
                    per.append(launch_counts())
                assert all(math.isfinite(v.item()) for m in metrics for v in m.values())
                moved = max(float((p.detach() - before[k]).abs().max())
                            for k, p in bb.named_parameters())
                return per, moved, times, peak_gib()

            n, (per, moved, times, peak) = fitting_batch(
                steps, start[1] if remat else rec["compare_batch"])
            assert moved > 0.0, f"{name}: the backbone did not move"
            key = "remat" if remat else "no_remat"
            rec[key] = {"batch": n, "launches_per_step": per[-1],
                        "step_ms": sum(times[1:]) / ZOO_TIMED_STEPS, "step_ms_each": times,
                        "peak_gib": peak, "backbone_moved": moved}
            launches[f"{name}_{key}"] = per[-1]
        log(f"{smi}: backbone training {name} " + json.dumps(rec))
        del model, optimizer, step, bb
        free_device()
    results["backbone_training"] = out
    return launches


# ---------------------------------------------------------------- phase 8 #


def k3_cost(r, l, u, nnz, layers, train, backward):
    """``(bf16 operations, f32 operations, bytes)`` of one K3a stack call
    of ``layers`` layers (or one K3b layer call), as the function needs
    them: the projections' multiply-adds; the measure's scores at the
    sampled keys only (``nnz``: the count matrices' nonzeros over the
    layers); the selected queries' scores (bf16 operands) and p.v (f32),
    and in the backward ds.k and ds^T.q (bf16) and dv and dp (f32). Bytes:
    x (and g) read and y (dx) written once per call, each layer's weights
    (and their grads), counts and, in training, masks once, and the layer
    inputs the training stack keeps for K3b."""
    d, f = K3_D, K3_F
    m = r * l
    gemm = 2 * m * (4 * d * d + 2 * d * f)
    measure = 2 * r * nnz * d  # every head's scores at each query's sampled keys
    sel = 2 * r * u * l * d  # one (u x L) by (L x dh) product per head
    weights = 4 * (4 * d * d + 2 * d * f + 9 * d + f)
    per_layer = weights + 4 * l * l + (m * (2 * d + f) if train else 0)
    if not backward:
        kept = 4 * m * d * layers if train else 0
        return (layers * (gemm + sel) + measure, layers * sel,
                4 * 2 * m * d + layers * per_layer + kept)
    # recompute (measure and selection), dX and dW of the six projections
    return (3 * gemm + measure + 3 * sel, 3 * sel,
            4 * 3 * m * d + per_layer + weights)


def device_parts(run, reps: int = 3) -> dict:
    """Device time of one call of ``run`` (torch.profiler over ``reps``),
    split into K3's attention core, its GEMMs and its row kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    groups, _ = device_groups(prof, reps)
    return {"attention_ms": groups.get("K3 attention", 0.0),
            "gemm_ms": groups.get("K3 gemm", 0.0), "rows_ms": groups.get("K3 rows", 0.0),
            "us_per_launch": launch_times(prof)}


def launch_times(prof) -> dict:
    """Device µs per launch of each K3 kernel in a torch.profiler run, by
    name with its template arguments (a GEMM by its epilogue)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        label = next((label for tag, label in KERNEL_TAGS if tag in e.key), "")
        if e.device_type != DeviceType.CUDA or t <= 0 or not label.startswith("K3"):
            continue
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        out[name.removeprefix("void ")[:80]] = t / e.count
    return out


def k3_times() -> dict:
    """K3a and K3b per flagship train step: K3a one stack call (8 layers,
    as the fused stack runs it, keeping each layer's input for K3b) at each
    geometry, K3b one layer call; kernel and plain times times the calls per
    step (K3b: 8 per backward stack). K3a's ``dinov2_*`` keys: the DinoV2
    frame encoder's stack (eval, one call) per batch-1 forward."""
    import torch

    from routeformer_torch.ops import fusion_stack as fs

    acc = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0,
               "attention_ms": 0.0, "gemm_ms": 0.0, "rows_ms": 0.0}
           for k in ("K3a", "K3b")}
    for name, r, l, calls in K3_GEOMS + [K3_DINO]:
        dino = name == K3_DINO[0]
        u = fs.prob_sparse_u(l, K3_FACTOR)
        x, w, masks, cnt = k3_inputs(r, l, seed=1, train=not dino)
        kw_stack = fs.kernel_weights(w)
        p = 0.0 if dino else K3_P
        g = torch.randn_like(x)
        wl, ml, c = layer_of(w, 0), layer_of(masks, 0), cnt[0].contiguous()
        kw = dict(heads=K3_H, u=u, dropout_rate=p, activation="gelu")
        runs = {"K3a": (
            lambda: fs.stack_forward_cuda(x, w, kw_stack, cnt, masks, compute_bf16=True,
                                          keep_inputs=not dino, **kw),
            lambda: fs.stack_reference(x, w, cnt, masks, compute_bf16=True, **kw),
            calls, K3_N)}
        if name in K3_BACKWARD:
            kw_layer = fs.KernelWeights(*(t[0] for t in kw_stack))
            runs["K3b"] = (
                lambda: fs.layer_backward_cuda(x, g, wl, c, ml, compute_bf16=True,
                                               kernel_w=kw_layer, **kw),
                lambda: fs.layer_backward(x, g, wl, c, ml, mm_dtype=torch.bfloat16, **kw),
                K3_N, 1)
        for kernel, (run, plain, n_calls, layers) in runs.items():
            t = cuda_ms(run)
            tp = cuda_ms(plain, iters=3, warmup=1)
            parts = device_parts(run)
            nnz = int((cnt[:layers] > 0).sum())
            bf, f32, nbytes = k3_cost(r, l, u, nnz, layers, masks is not None,
                                      kernel == "K3b")
            ops_s = bf / PEAK_BF16 + f32 / PEAK_F32
            bytes_s = nbytes / PEAK_BYTES
            if dino:
                acc[kernel].update(dinov2_ms=t, dinov2_plain_ms=tp,
                                   dinov2_bound_ms=1e3 * max(ops_s, bytes_s),
                                   dinov2_bound_by="operations" if ops_s >= bytes_s else "bytes",
                                   dinov2_parts=parts)
            else:
                a = acc[kernel]
                a["ms"] += n_calls * t
                a["plain_ms"] += n_calls * tp
                a["bound_ms"] += n_calls * 1e3 * max(ops_s, bytes_s)
                a["ops_s"] += n_calls * ops_s
                a["bytes_s"] += n_calls * bytes_s
                for key, val in parts.items():
                    if key != "us_per_launch":
                        a[key] += n_calls * val
            log(f"{kernel} {name} ({r}, {l}, u={u}), {layers} layer(s) a call: {t:.3f} ms "
                f"(plain {tp:.3f}, bound {1e3 * max(ops_s, bytes_s):.4f}; device: "
                + ", ".join(f"{k} {v:.4f}" for k, v in parts.items() if k != "us_per_launch")
                + f") x {n_calls}; µs per launch: " + json.dumps(parts["us_per_launch"]))
        del x, w, masks, cnt, g, kw_stack, runs
        torch.cuda.empty_cache()
    return acc


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed back to back, so that the host's time to launch
    them is not in it (``cuda_ms`` times eager calls, host included)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    t = cuda_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return t


def k2_times() -> dict:
    """K2 per batch-1 flagship forward (STAGES). ``ms``: the path's variant,
    f32 strided views of a qkv buffer as K1 launches it, with 1 window kind
    in an unshifted block and nw in a shifted one, as device time
    (``graph_ms``); its plain version on the same views. ``bf16_ms``: the
    bf16 (B, H, n, d) wrapper at 1 window kind, device time, and
    ``bf16_eager_ms`` the same as back-to-back eager calls through its
    autograd Function, the host's time included. SDPA on
    the bf16 case (q normalised and scaled, k normalised beforehand, the
    bias as a bf16 mask), device time and eager. Bounds: 4 B H n^2 d bf16
    operations against q, k, v read and the bf16 output written once, and
    the bias once per window kind."""
    import torch
    import torch.nn.functional as F

    from routeformer_torch.ops import flash_attention as fa

    keys = ("ms", "plain_ms", "bound_ms", "ops_s", "bytes_s", "bf16_ms", "bf16_eager_ms",
            "bf16_bound_ms", "library_ms", "library_eager_ms")
    acc = dict.fromkeys(keys, 0.0)
    for name, b, n, c, h, count, nw in STAGES:
        d = c // h
        flops = 4 * b * h * n * n * d
        for kinds in ([1, nw] if nw else [1]):
            reps = count // 2 if nw else count
            qkv, bias, scale = k2_path_inputs(b, n, c, h, kinds, seed=3)
            out = torch.empty(b * n, c, dtype=torch.bfloat16, device="cuda")
            t = graph_ms(lambda: k2_path(qkv, bias, scale, b, n, c, h, out))
            tp = cuda_ms(lambda: k2_path_plain(qkv, bias, scale, b, n, c, h), iters=3, warmup=1)
            nbytes = b * n * c * (3 * 4 + 2) + kinds * h * n * n * 4 + h * 4
            bt, _ = bound_ms(flops, nbytes)
            for key, val in (("ms", t), ("plain_ms", tp), ("bound_ms", bt),
                             ("ops_s", flops / PEAK_BF16), ("bytes_s", nbytes / PEAK_BYTES)):
                acc[key] += reps * val
            log(f"K2 {name} f32 strided, {kinds} window kind(s): {t:.4f} ms (plain {tp:.3f}, "
                f"bound {bt:.4f}) x {reps}")
            del qkv, bias, out

        q, k, v, wb, scale = k2_inputs(b, h, n, d, 1, seed=2)
        qn = (fa._normalise(q.float()) * scale.view(1, h, 1, 1)).bfloat16()
        kn = fa._normalise(k.float()).bfloat16()
        mask = wb.bfloat16()

        def kernel():
            return fa.flash_window_attention(q, k, v, wb, scale, cosine=True)

        def lib():
            return F.scaled_dot_product_attention(qn, kn, v, attn_mask=mask, scale=1.0)

        t, te, tl, tle = graph_ms(kernel), cuda_ms(kernel), graph_ms(lib), cuda_ms(lib)
        bt, _ = bound_ms(flops, 4 * b * h * n * d * 2 + h * n * n * 4 + h * 4)
        for key, val in (("bf16_ms", t), ("bf16_eager_ms", te), ("bf16_bound_ms", bt),
                         ("library_ms", tl), ("library_eager_ms", tle)):
            acc[key] += count * val
        log(f"K2 {name} bf16: {t:.4f} ms (eager {te:.4f}; sdpa {tl:.4f}, eager {tle:.4f}; "
            f"bound {bt:.4f}) x {count}")
        del q, k, v, wb, scale, qn, kn, mask
        torch.cuda.empty_cache()
    log("K2 per batch-1 forward: " + json.dumps(acc))
    return acc


# Keys of a kernel's timing kept in its entry beside the contract's: K2's
# bf16 wrapper timings (k2_times), K4's time on the ViT's views (k4_times),
# K1's GEMMs against cuBLAS (k1_gemm_times), K3's device time by part
# (k3_times).
EXTRA_KEYS = ("bf16_ms", "bf16_eager_ms", "bf16_bound_ms", "library_eager_ms", "views_ms",
              "gemm_ms", "gemm_library_ms", "gemm_graph_ms", "gemm_library_graph_ms",
              "gemm_stage_ms", "attention_ms", "rows_ms", "dinov2_ms", "dinov2_plain_ms",
              "dinov2_bound_ms", "dinov2_bound_by", "dinov2_parts",
              "dinov2_launches_per_forward")


def k1_gemm_times() -> dict:
    """The block's four GEMMs per batch-1 flagship forward: on the GEMM core
    as K1's pipeline calls them (``gemm_ms``), and through ``F.linear`` on
    the same bf16 operands (cuBLAS, bf16 output, gelu left out: the
    yardstick, ``gemm_library_ms``), eager; ``gemm_graph_ms`` and
    ``gemm_library_graph_ms`` the same as device time (``graph_ms``); per
    stage and block in ``gemm_stage_ms``."""
    import torch.nn.functional as F

    from routeformer_torch.ops import swin_block_fusion as sbf

    out = {"gemm_ms": 0.0, "gemm_library_ms": 0.0, "gemm_graph_ms": 0.0,
           "gemm_library_graph_ms": 0.0, "gemm_stage_ms": {}}
    for name, b, n_tok, c, _, count, _ in STAGES:
        ops = [k1_gemm_inputs(b * n_tok, n, k, dtype, seed=k) + (act,)
               for n, k, act, dtype in k1_gemms(c)]

        def core():
            for a, w, bias, o, act in ops:
                sbf.gemm_bias_act(a, w, bias, o, act)

        def library():
            for a, w, bias, _, _ in ops:
                F.linear(a, w, bias.bfloat16())

        t, tl, tg, tlg = cuda_ms(core), cuda_ms(library), graph_ms(core), graph_ms(library)
        out["gemm_ms"] += count * t
        out["gemm_library_ms"] += count * tl
        out["gemm_graph_ms"] += count * tg
        out["gemm_library_graph_ms"] += count * tlg
        out["gemm_stage_ms"][name] = {"core": t, "library": tl, "core_graph": tg,
                                      "library_graph": tlg}
        log(f"K1 {name} four GEMMs: core {t:.4f} ms, F.linear {tl:.4f} ms ({t / tl:.2f}x); "
            f"device: core {tg:.4f}, F.linear {tlg:.4f} ({tg / tlg:.2f}x) x {count}")
        del ops
    return out


def kernel_line(launches: dict, results: dict) -> dict:
    import torch

    from routeformer_torch.ops import swin_block_fusion as sbf

    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0}
    for name, b, n, c, h, count, nw in STAGES:
        # K1 at this geometry (the unshifted bias; a shifted block differs
        # only in its bias's window kinds).
        x, params, bias = k1_inputs(b, n, c, h, None, seed=1)
        t = cuda_ms(lambda: sbf.fused_swin_block(x, params, bias, h, True))
        tp = cuda_ms(lambda: sbf.fused_swin_block_plain(x, params, bias, h, True),
                     iters=3, warmup=1)
        flops = 2 * b * n * (12 * c * c + 2 * n * c)
        nbytes = 2 * b * n * c * 2 + 12 * c * c * 2 + 13 * c * 4 + h * n * n * 4 + h * 4
        bt, _ = bound_ms(flops, nbytes)
        k1["ms"] += count * t
        k1["plain_ms"] += count * tp
        k1["bound_ms"] += count * bt
        k1["ops_s"] += count * flops / PEAK_BF16
        k1["bytes_s"] += count * nbytes / PEAK_BYTES
        log(f"K1 {name}: {t:.3f} ms (plain {tp:.3f}, bound {bt:.4f}) x {count}")
        del x, params, bias
        torch.cuda.empty_cache()
    k1.update(k1_gemm_times())

    def entry(name, source, replaces, acc, err, library_ms, ms_per,
              per_forward=results["serve_launches_per_forward"], ms_timing="eager"):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "launches_per_step": [c[name] for c in results["train_launches_per_step"]],
            "launches_per_forward": per_forward[name],
            "training_run_launches": {run: counts[name] for run, counts
                                      in results["training_run_launches"].items()},
            "full_set_launches": results["full_set_launches"][name],
            "gem_data_path_launches": results["gem_data_path_launches"][name],
            "export_launches_per_forward": results["export_launches"][
                "dinov2" if name == "K4" else "flagship"][name],
            "dreyeve_data_path_launches": results["dreyeve_data_path_launches"][name],
            "mesh_launches_per_step": results["mesh_launches_per_step"][name],
            "zoo_launches_per_step": {run: counts[-1][name] for run, counts
                                      in results["zoo_launches_per_step"].items()},
            "backbone_training_launches_per_step": {
                run: counts[name] for run, counts
                in results["backbone_training_launches_per_step"].items()},
            "max_abs_err": err, "ms_per": ms_per, "ms_timing": ms_timing,
            "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": "operations" if acc["ops_s"] >= acc["bytes_s"] else "bytes",
            "library_ms": library_ms,
            **{key: acc[key] for key in EXTRA_KEYS if key in acc},
        }

    k2 = k2_times()
    k3 = k3_times()
    fused = results["dinov2"]["fused"]
    k3["K3a"]["dinov2_launches_per_forward"] = fused["launches_per_forward"]["K3a"]
    k4 = k4_times()
    per_forward, per_step = "batch-1 serving forward", f"batch-{TRAIN_BATCH} train step"
    return {"kernels": [
        entry("K1", "routeformer_torch/csrc/swin_block.cu",
              "routeformer_tpu/ops/swin_block_fusion.py:57", k1,
              results["k1_max_abs_err"], None, per_forward),
        entry("K2", "routeformer_torch/csrc/window_attention.cu",
              "routeformer_tpu/ops/flash_attention.py:120", k2,
              results["k2_max_abs_err"], k2["library_ms"], per_forward, ms_timing="graph"),
        # No single PyTorch call computes a ProbSparse encoder layer.
        entry("K3a", "routeformer_torch/csrc/perceive_stack.cu",
              "routeformer_tpu/ops/fusion_stack.py:357", k3["K3a"],
              results["k3a_max_abs_err"], None, per_step),
        entry("K3b", "routeformer_torch/csrc/perceive_stack.cu",
              "routeformer_tpu/ops/fusion_stack.py:599", k3["K3b"],
              results["k3b_max_abs_err"], None, per_step),
        entry("K4", "routeformer_torch/csrc/dense_attention.cu",
              "routeformer_tpu/ops/flash_attention.py:36", k4, results["k4_max_abs_err"],
              k4["library_ms"], "batch-1 DinoV2 serving forward",
              per_forward=results["dinov2"]["launches_per_forward"]),
    ]}


def k4_times() -> dict:
    """K4 per batch-1 DinoV2 forward: one launch at K4_SHAPE (bf16, scale
    1/8, non-causal) times K4_PER_FORWARD, beside the plain version and
    SDPA on the same tensors; ``views_ms``: the same work on the ViT's
    (B, L, H, E) views of a qkv buffer through ``dot_product_attention``,
    the path's variant. Bound: 4 BH L^2 E operations
    with bf16 operands against q, k, v read and the output written once."""
    import torch.nn.functional as F

    from routeformer_torch.ops import attention
    from routeformer_torch.ops import flash_attention as fa

    bh, l, e = K4_SHAPE
    q, k, v = k4_inputs(bh, l, e, e, "bfloat16", seed=11)
    scale = 1.0 / math.sqrt(e)
    t = cuda_ms(lambda: fa.flash_attention_bhle(q, k, v, False, scale))
    tp = cuda_ms(lambda: fa.attention_bhle_plain(q, k, v, False, scale), iters=3, warmup=1)
    heads = 12
    q4, k4, v4 = (x.view(bh // heads, heads, l, e) for x in (q, k, v))
    tl = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    del q, k, v, q4, k4, v4
    b = bh // heads
    qv, kv, vv = k4_views(b, l, heads, e, seed=12)

    def views():  # the ViT's call: K4 on the views, the output reshaped in place
        return attention.dot_product_attention(qv, kv, vv, impl="flash").reshape(b, l, -1)

    tv = cuda_ms(views)
    flops, nbytes = 4 * bh * l * l * e, 4 * bh * l * e * 2
    bt, by = bound_ms(flops, nbytes)
    n = K4_PER_FORWARD
    log(f"K4 {K4_SHAPE}: {t:.3f} ms (on the ViT's views {tv:.3f}; plain {tp:.3f}, "
        f"sdpa {tl:.3f}, bound {bt:.4f} by {by}) x {n}")
    return {"ms": n * t, "plain_ms": n * tp, "library_ms": n * tl, "bound_ms": n * bt,
            "ops_s": n * flops / PEAK_BF16, "bytes_s": n * nbytes / PEAK_BYTES,
            "views_ms": n * tv}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from routeformer_torch.ops import cuda_build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32 (Informer)
    torch.backends.cuda.matmul.allow_tf32 = False

    cuda_build.libraries()
    log(f"kernels built in {cuda_build.build_info['seconds']:.1f} s")
    for name, text in cuda_build.build_info["ptxas"].items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "Performance")):
                log(f"ptxas {name}: {line.strip()}")

    results = {}
    check_k2(results)
    check_k1(results)
    check_gemm_core(results)
    serve_flagship(results)
    check_k4(results)
    k4_launches = serve_dinov2(results)
    results["export_launches"] = export_phase(results, smi)
    check_k3a(results)
    check_k3a_measure(results)
    check_k3b(results)
    check_k3b_selection(results)
    check_k3b_determinism(results)
    check_k12_grad(results)
    launches = train_flagship(results)
    launches["K4"] = k4_launches  # K4's path is DinoV2 serving
    train_parity(results)
    results["training_run_launches"] = training_run(results, smi)
    results["mesh_launches_per_step"] = mesh_phase(results, smi)
    two_rank_phase(results, smi)
    results["full_set_launches"] = full_set_run(results, smi)
    heatmap_batches = {}
    results["gem_data_path_launches"], heatmap_batches["gem"] = gem_data_path(results, smi)
    results["dreyeve_data_path_launches"], heatmap_batches["dreyeve"] = dreyeve_data_path(
        results, smi)
    gaze_heatmaps(results, smi, heatmap_batches)
    card_cpu, results["zoo_launches_per_step"] = zoo_remainder(results, smi)
    results["backbone_training_launches_per_step"] = backbone_training(results, smi, card_cpu)
    line = kernel_line(launches, results)
    log(f"results: {json.dumps(results)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
