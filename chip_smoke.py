#!/usr/bin/env python3
"""Smoke test of the PyTorch port (reduced_3dgs_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

  phase 0  card name, power limit and software versions
  phase 1  build every CUDA kernel from the sources in the checkout, one
           nvcc process per source, all at once, and print each kernel's
           registers, shared memory and spills as ptxas reports them
  phase 2  the bench scene: 200,000 Gaussians at SH degree 3, 544x976, and
           its perturbed copy (bench.py's perturbation)
  phase 3  the bench scene's entries per tile (mean, p99, max), then each
           kernel against its plain PyTorch version on the card, on
           the bench scene, an opaque scene and a fully culled scene: the
           forward compositor, the statistics compositor (also against the
           forward compositor, bit for bit), the backward compositor
           (cotangents from a real loss and random ones; its per-Gaussian
           form also against its per-entry form summed by index_add_), and
           the SSIM gradient against float64 and against float32 on the CPU
  phase 4  the render entry point (reduced_3dgs_torch.render.main) on a
           4-view COLMAP dataset of the bench scene, with the kernels'
           launch counts read around it
  phase 5  timing with CUDA events (median of 20 after warm-up): each
           kernel and its plain version (and the share of its bound it
           reaches; the statistics compositor also by its device time
           under torch.profiler), a render and a training step with
           their stage splits, an importance-pruning sweep and an SH cull
           over the 4 views, and the device idle share under torch.profiler
  phase 6  the training path: train.training() with a Trainer for 20 steps
           on the 4-view dataset from the perturbed bench scene, with the
           kernels' launch counts read around it
  phase 7  the reduction path: train.training() for 30 steps with
           SHCullingTrainerWrapper(BaseImportancePruningTrainer, ...), which
           prunes by importance after steps 10 and 20 and culls SH bands
           after step 15, with the launch counts, N and the degrees read
           around each event
  phase 8  the densification path: train.training() for 30 steps with
           SHCullingOpacityResetDensificationTrainer on the 4 views, each
           with a ground-truth depth map: split/clone after steps 10, 20 and
           30 (the gradient threshold calibrated by a run of the first 10
           steps), the opacity/size prune every 5 steps from 15, the SH cull
           after 15, the opacity reset after 30; each event's N, counts and
           time, the launch counts, the backward compositor's depth and
           final_T cotangents, and the step time at the grown N
  phase 9  the flagship: (a) knn(k=30) on the bench scene's 200,000 centres
           and on a 262,144-point clustered cloud, timed, with recall@30
           against an exact oracle on 2,048 queries, and mean_knn_dist_sq
           against the exact two nearest neighbours; (b) colmap_init from a
           binary COLMAP dataset holding the bench scene's centres and
           colours; (c) one mercy event at the bench scene over the 4 views,
           timed by stage and under torch.profiler, and its mask on a
           20,000-Gaussian subset against the same event on the CPU; (d)
           train.training() for 30 steps with
           SHCullingOpacityResetFullReducedDensificationTrainer on phase 8's
           views, start and calibration: split/clone after 10, 20 and 30, the
           opacity and mercy prune every 5 steps from 15, the importance prune
           after 20, the SH cull after 15, the opacity reset after 30; each
           event's N bookkeeping and time, and the launch counts, which the
           kernels line reports
  phase 10 quantization, the CLIs and checkpoints: (a) kmeans of each of
           the eight attributes at the bench scene on the card and on the
           CPU, 10 Lloyd iterations of 256 centres in lockstep, and timed
           on the card; (b)
           ExcludeZeroSHQuantizer.quantize cold and warm, by attribute, and
           a warm event under torch.profiler; (c) train.main
           --mode densify-pruning-shculling --quantize --with_scale_reg for
           30 steps on phase 9's views, start and schedule, with quantize
           events at the start of steps 11 and 21 and the launch counts read
           around it; (d) quantize.main on its PLY, then render.main
           --load_quantized and render.main of the dequantized PLY, equal,
           with their launch counts and the size ratio; (e) a Trainer's
           checkpoint after 20 steps, loaded into a fresh trainer, and 5 more
           steps on both
  phase 11 trainable cameras: (a) train.main --mode
           camera-densify-pruning-shculling for 30 steps on phase 9's views,
           start and schedule, with the launch counts (which the kernels line
           reports), N, the median ordinary step beside phase 9's, one step's
           idle share under torch.profiler and each view's learned pose; (b)
           one step's camera gradient on the card against the CPU on the
           20,000 Gaussians of smallest x; (c) render.main --load_camera of
           the run's cameras.json and PLY, its renders against the trainer's
           adjusted cameras'; (d) render_packed of the trained SH-culled
           model against its dense render; (e) mark_visible's count per view
  phase 12 the surfel backend and the remaining modules: (a) train.main
           --backend gsplat-2dgs in the flagship mode for 30 steps and in the
           camera flagship mode for a few, on phase 9's views, start and
           schedule: N around each event, step times, peak memory, one
           step's idle share, view 0's entry count beside the 3DGS
           renderer's, and the compositors' launches, which must be 0; (b)
           one 2DGS render, backward and statistics render of the 20,000
           Gaussians of smallest x on the card against the CPU; (c) a late
           tile of the full 2DGS render against the render of only the
           Gaussians covering it; (d) the viewer over HTTP, its frames
           against direct renders; (e) LPIPS with seeded weights on the card
           against the CPU with TF32 off (and missing the bar with it
           allowed), and render.main reporting it; (f) the native PLY
           writer and reader against numpy at the bench scene; (g)
           utils.profiling's trace and time_fn
  phase 13 the band viewport and parallel/: (a) the bench scene rendered
           as the bands of 2, 3 and 4 tile ranks in turn through
           render_band, stitched, against one full render (colour, T,
           depth), the bands' entry counts summing to the image's, their
           statistics summing to the image's, and the loss gradient
           through the spliced bands against the full render's, with the
           compositors' launches (n bands, n launches); the 2DGS model's
           bands, which launch none; (b) train.main in the flagship mode for
           20 steps from phase 9's start and calibration, with one densify
           event and one importance sweep, and with --mesh 1x1 (the sharded
           trainer on a world of one) for 10 steps, the same losses; (c) the
           same run over two processes on the card, over gloo, with --mesh
           1x2 (each camera in two bands) and --mesh 2x1 (two cameras a
           step), started as ``chip_smoke.py --mesh-rank`` with torchrun's
           variables: both ranks' replicas bitwise equal, N moving at the
           events, each rank's launches, the 1x2 run's losses against the
           single process's, and the step times
  phase 14 the convergence proof: reduced_3dgs_torch.tools.convergence_proof's
           run() at the full preset (a procedural scene of 120,000 Gaussians
           rendered from 24 views of 544x976 with sensor noise, 6,000 noisy
           init points, 2000 steps of the flagship, the raw and quantized
           PLY, then 2000 steps of the unpruned baseline): the compositors'
           launches against the schedule's (2 per step, one per ground-truth
           and evaluation render, one per view per importance sweep and two
           per view per SH cull), N moving only after the event steps, the
           cull lowering degrees, the tool's four bars, the median ordinary
           step of both runs, and the PSNR of the quantized PLY loaded back
  phase 15 the fused step windows (trainer.step_many, the static key buffer,
           the step captured as a CUDA graph): (a) one eager fixed-shape
           step of the 3DGS and of the 2DGS model at the bench scene under
           torch.cuda.set_sync_debug_mode("error"), and a window of 3 of
           each against 3 single steps; (b) a
           window of 16 steps (one capture, 15 replays) against 16 single
           steps from one state, and the loss gradient with the key buffer
           at twice its entries
           against the exact buffer's (the buffer's tail reaches no
           Gaussian); (c) windows of 16 timed with CUDA events beside
           Trainer.step, one window's idle share under torch.profiler, each
           capture's time and pool memory, and the key buffer against the
           entries after two drains; (d) phase 9's flagship through
           train.training with R3DGS_WINDOW=16: the windows against the
           schedule's, N moving only after event steps, the launches

  phase 16 the one-program event sweeps (importance counts and the SH cull's
           colour statistics through the static key buffer, one captured
           CUDA graph replayed per view): (a) each sweep's per-view body at
           the bench scene under torch.cuda.set_sync_debug_mode("error");
           (b) the graph sweeps against the eager exact per-view loop over
           the 4 views, and their launches; (c) the eager loop and the graph
           sweep timed at 4 and 64 views for the importance sweep (its first
           call, capture included, and a repeat) and the cull, the capture's
           time and pool memory, K and the passes, and the idle share of one
           graph sweep under torch.profiler; (d) a forced overflow, regrown
           in passes; (e) the statistics compositor's launches of phases 7,
           9, 14 and 15 against their schedules

  phase 17 the preprocess kernels (csrc/preprocess.cu) alone against the
           plain preprocess, at the bench scene and at its distribution with
           1,250,000 Gaussians, view 0: the forward kernel's outputs; every
           gradient of the backward kernel, in the training step's form and
           with the camera's, against autograd through the plain version
           (relative norm of the difference, bars 1e-4 and the camera's
           1e-3), and the camera form's distance from autograd in float64
           beside the plain float32 version's; in ms (CUDA events) the
           forward kernel, the backward kernel (both forms), the plain
           forward, the plain backward and both pairs forward and backward;
           each kernel's device time under torch.profiler, and its bytes over
           either time as a share of the card's 3.35 TB/s. The kernels'
           launches on the last line are those of phases 11, 14, 15 and 16,
           which check them against their renders: one forward kernel a
           render, one backward kernel a B3 (phase 6 too)
  phase 18 the binning kernels (csrc/binning.cu) against the plain binning
           on the card, bit for bit, at the bench scene and at its
           distribution with 1,250,000 Gaussians, view 0, through the
           trainer's static key buffer and through the exact one; in ms (CUDA
           events) bin_count, bin_sort, both together and the plain version
           of each buffer; the device time of each kernel under
           torch.profiler; the bytes the layer must move over those times as
           a share of the card's 3.35 TB/s. Their launches, like the
           preprocess kernels', are those of phases 11, 14, 15 and 16, which
           hold them to their renders: one of each a render
  phase 19 the Adam kernel (csrc/adam.cu) alone: one step against the
           plain version (relative norm gap of every p, m and v, bar 1e-6)
           at 1,250,000 Gaussians (59 floats each, the six parameters'
           shapes, xyz's rate a 0-d tensor: the 16-byte path), at 627,001
           (the scalar tail of sizes that are no multiple of 4) and on a
           camera's state (rot and trans, float rates); at 1,250,000, in ms
           (CUDA events, the L2 flushed before each call) the kernel's step,
           the plain version's and PyTorch's fused multi-tensor Adam's
           (torch._fused_adam_, one call a learning rate, its float step
           counts advanced by one _foreach_add_), and the kernel's step over
           ten back to back; the device time and launches of each under
           torch.profiler, the L2 flushed before each call, against the
           bound (28 B a float at 3.35 TB/s); the fused Adam's gap to the
           plain version. The kernel's launches, like the preprocess
           kernels', are those of phases 11, 14, 15 and 16, which hold them
           to the steps taken: one a step of each optimizer state, so one
           a flagship step and two a camera step (phases 6 holds them so
           too)

Phases 0-14 run with R3DGS_WINDOW=1 (one step per trainer.step call, which
their checks wrap); phase 15 sets 16 for its training run. The kernels
line's launches are the sums of phases 11, 14, 15 and 16 (each also given
by phase). Any failed check raises, so the script exits non-zero without its last
line. The last two lines are a JSON record of each kernel and
{"ok": true, "device": {...}}. Without CUDA it exits with status 2.
"""
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_GAUSSIANS = 200_000
HEIGHT, WIDTH = 544, 976
FOVX, FOVY = math.radians(70), math.radians(45)
FOCAL_X, FOCAL_Y = WIDTH / (2 * math.tan(FOVX / 2)), HEIGHT / (2 * math.tan(FOVY / 2))
N_VIEWS = 4
REPEATS = 20
TRAIN_STEPS = 20
# The reduction path of phase 7: importance pruning after steps 10 and 20,
# the SH cull after step 15, one SH band more every 4 steps.
REDUCTION_STEPS = 30
REDUCTION_CONFIG = dict(importance_prune_from_iter=10, importance_prune_until_iter=20,
                        importance_prune_interval=10, cull_at_steps=[15],
                        sh_degree_up_interval=4)
PRUNE_STEPS, CULL_STEPS = (10, 20), (15,)
# The densification path of phase 8 (SHCullingOpacityResetDensificationTrainer):
# split/clone after steps 10, 20 and 30, the opacity/size prune every 5 steps
# from 15 (its size criteria from 15 on; 20 and 30 coincide with a split),
# the SH cull after step 15, the opacity reset after step 30, the last: the
# gradients of the nearly transparent Gaussians a reset leaves would keep a
# densify a few steps later from adding points.
DENSIFY_STEPS = 30
DENSIFY_CONFIG = dict(densify_from_iter=10, densify_until_iter=30, densify_interval=10,
                      prune_from_iter=15, prune_until_iter=30, prune_interval=5,
                      prune_big_from_iter=14, opacity_reset_interval=30,
                      opacity_reset_until_iter=30, opacity_reset_value=0.01,
                      cull_at_steps=[15], sh_degree_up_interval=4)
SPLIT_STEPS, DPRUNE_STEPS, RESET_STEPS, DCULL_STEPS = (10, 20, 30), (15, 20, 25, 30), (30,), (15,)
# The views sit within 0.1 of each other, so vanilla 3DGS's size bars, which
# are shares of the cameras' extent (clone below 1% of it, prune above 10%),
# would call every Gaussian of the scene large. Phase 8 sets them from the
# scene's own largest scales instead: clone at or below their median, prune
# above their 99th percentile.
CLONE_SCALE_QUANTILE, BIG_SCALE_QUANTILE = 0.5, 0.99
# The perturbed scene's screen-space gradients are not a trained scene's, so
# the split/clone gradient threshold is calibrated too: a run of the same
# first 10 steps (same model, loss and camera order) sets it at the 90th
# percentile of the mean gradient, so that a tenth of the Gaussians densify
# at the first event.
HOT_SHARE = 0.1
# Phase 9: KNN at k = 30 (mercy pruning's), recall against an exact oracle
# on 2,048 queries (tools/knn_recall.py's protocol), 5 timed runs.
KNN_K = 30
CLUSTER_POINTS = 262_144
RECALL_QUERIES = 2048
MIN_RECALL = 0.95
PHASE9_REPEATS = 5
# The mercy event's CPU comparison: the 20,000 Gaussians of smallest x, a
# slab of the scene at its full density, at the default box size and at a
# box size where the redundant set is not empty.
MERCY_SUBSET = 20_000
MERCY_BOXES = (1.0, 4.0)
# A decision within this share of its threshold is reported.
DECISION_MARGIN = 1e-5
# The flagship path of phase 9 (SHCullingOpacityResetFullReducedDensification-
# Trainer): phase 8's schedule, the mercy prune with the opacity prune, the
# importance prune after step 20 (ImportancePruner's defaults otherwise).
FLAGSHIP_STEPS = 30
FLAGSHIP_CONFIG = dict(densify_from_iter=10, densify_until_iter=30, densify_interval=10,
                       prune_from_iter=15, prune_until_iter=30, prune_interval=5,
                       importance_prune_from_iter=20, importance_prune_until_iter=20,
                       importance_prune_interval=20, opacity_reset_interval=30,
                       opacity_reset_until_iter=30, opacity_reset_value=0.01,
                       cull_at_steps=[15], sh_degree_up_interval=4)
F_SPLIT, F_PRUNE, F_IMPORTANCE, F_CULL, F_RESET = (10, 20, 30), (15, 20, 25, 30), (20,), (15,), (30,)
# Phase 10: K-Means of each attribute on the card against the CPU, 10 Lloyd
# iterations of 256 centres in lockstep; updated centres within 1e-4.
KMEANS_CLUSTERS = 256
KMEANS_ITERATIONS = 10
TOL_KMEANS_CENTERS = 1e-4
# The quantizing flagship CLI: phase 9's schedule, and a quantize event at
# the start of steps 11 and 21. The quantized model's two render paths agree
# to 1e-6, and its PLY is at most 0.2 of the raw one.
QUANTIZE_CLI_CONFIG = dict(quantize_from_iter=10, quantize_interval=10)
Q_STEPS = (11, 21)
TOL_QUANTIZED_RENDER = 1e-6
MAX_QUANTIZED_SIZE_RATIO = 0.2
# Checkpoint resume: 20 steps, save, load into a fresh trainer, 5 more steps
# on both; losses within 1e-5 (relative), parameters within the JAX
# package's gradient bars, rtol 2e-3 and atol 3e-5.
CKPT_STEPS, CKPT_MORE_STEPS = 20, 5
TOL_CKPT_LOSS_REL = 1e-5
TOL_CKPT_RTOL, TOL_CKPT_ATOL = 2e-3, 3e-5
# Phase 11: the camera flagship (train.main --mode
# camera-densify-pruning-shculling) on phase 9's views, start and schedule;
# its camera gradient on the card against the CPU at the JAX package's
# gradient bars (rtol 2e-3, atol 3e-5 of max|g|), on the MERCY_SUBSET
# Gaussians of smallest x; the learned poses read back and the packed-SH
# model within the forward compositor's colour bar (TOL_COLOR).
CAMERA_MODE = "camera-densify-pruning-shculling"
GCAM_RTOL, GCAM_ATOL = 2e-3, 3e-5
# Box sizes tried on the first mercy event's model when the default removes
# nothing.
MERCY_FIRE_BOXES = (2.0, 4.0, 8.0, 16.0)
# sigmoid(inverse_sigmoid(v)) may land an ulp or two above v.
RESET_TOL_REL = 1e-6
# Background of the camera whose loss gives the backward compositor's
# cotangents: non-zero, so that the final_T cotangent is too.
LOSS_BG = (0.2, 0.4, 0.6)
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations every (pixel, entry) pair the forward compositor scans
# needs at least: offsets (2), quadratic form (9), exp (1), gate (1).
OPS_PER_SCANNED_PAIR = 13
# The backward compositor evaluates the same 13-operation gate on every
# pair before each pixel's latch, and spends about 27 more on each pair that
# passes it (T_in and w 3, c.g 7, d alpha-bar 4, dpower 2, the conic and
# position partials 11).
OPS_PER_CONTRIBUTING_PAIR = 27
# The statistics compositor spends about 14 more on each pair that
# contributes: the blend (w, four colour sums, T: 10) and the four sums.
OPS_PER_STATS_CONTRIBUTING_PAIR = 14
# Colour and final_T agree to 1e-4 and depth to 5e-4: the bars the JAX
# package holds its own Pallas kernel to against its XLA path. The latch may
# flip where T (1 - alpha) sits on 1e-4, between sequential and log-space
# arithmetic, on at most 0.01% of pixels.
TOL_COLOR, TOL_DEPTH, MAX_LATCH_MISMATCH_SHARE = 1e-4, 5e-4, 1e-4
# Backward compositor vs its plain version, per gradient field: max |diff|
# at most this share of the plain version's max |value| (the kernel replays
# T by division, the plain version in log space, and sums in another order;
# the worst field on the bench and opaque scenes sits near 9e-7).
TOL_BWD_REL = 1e-5
# Statistics compositor vs its plain version: counts exact (the kernel's
# gate rounds as the plain version does) outside tiles whose latch differs;
# each score field within this share of the plain version's max |value|.
TOL_STATS_REL = 1e-5
STAT_FIELDS = ("count", "count_op", "w", "T_in")
# SSIM gradient in float32 on the card vs the same on the CPU, as a share
# of the float64 gradient's max |value| (see check_ssim_gradient).
TOL_SSIM_GRAD_REL = 1e-5
MIN_PSNR_DB = 40.0
FIELDS = ("x", "y", "A", "B", "C", "op", "r", "g", "b", "depth")
# The kernels by ptxas name, with their ids in PERF.md's table.
KERNEL_IDS = {"composite_fwd_kernel<false>": "B1", "composite_fwd_kernel<true>": "B2",
              "composite_bwd_kernel": "B3"}
# Phase 12: the surfel renderer's outputs and the JAX package's bars for
# them (card against CPU); the camera mode's steps; a late tile's pixels in
# the full render against the covering Gaussians alone; the viewer's
# requests and viewport; LPIPS on the card against the CPU.
TWODGS_OUTPUTS = ("render", "final_T", "depth", "normal", "distortion")
TWODGS_ATOL = {"render": 1e-4, "final_T": 1e-4, "normal": 1e-4, "depth": 5e-4,
               "distortion": 5e-4}
TWODGS_CAMERA_STEPS = 6
TOL_TILE = 1e-5
VIEWER_REQUESTS = 8
VIEWER_HEIGHT, VIEWER_WIDTH = 544, 960
TOL_LPIPS = 1e-6
# Phase 13: the bands of 2, 3 and 4 tile ranks against the full render
# (colour, T and depth within 1e-5: JAX tests/test_parallel.py:33; the 2DGS
# bands within 1e-5 of each output's largest value, TOL_TILE's bar: the
# surfel compositor's per-tile sums are index_add_'s float atomics, whose
# last bits vary from render to render), and the loss gradient through them
# within the backward compositor's bars; the flagship through train.main for 20 steps
# with one densify event (after step 10) and one importance sweep (after
# step 15), in one process, with --mesh 1x1 for 10 steps (losses within
# 1e-6, relative) and over two processes on the card with --mesh 1x2 and
# 2x1, each with its own time limit; the 1x2 run's losses within the
# gradient bars' 2e-3 of the single process's, and N within 1e-3.
BAND_TILES = (2, 3, 4)
TOL_BAND = 1e-5
BAND_GRAD_RTOL, BAND_GRAD_ATOL = 2e-3, 3e-5
MESH_STEPS, MESH_ONE_BY_ONE_STEPS = 20, 10
MESH_CONFIG = dict(densify_from_iter=10, densify_until_iter=10, densify_interval=10,
                   prune_from_iter=100, prune_until_iter=100, prune_interval=100,
                   importance_prune_from_iter=15, importance_prune_until_iter=15,
                   importance_prune_interval=15, opacity_reset_interval=100,
                   opacity_reset_until_iter=100, cull_at_steps=[100], sh_degree_up_interval=4)
M_SPLIT, M_IMPORTANCE = 10, 15
MESHES = ("1x2", "2x1")
MESH_TIMEOUT = 240
TOL_ONE_BY_ONE_REL = 1e-6
MESH_LOSS_RTOL, MESH_N_REL = 2e-3, 1e-3
# Phase 15: the fused step windows. (b) a window of WINDOW steps against as
# many single steps from one state, held as phase 10 (e) holds a resumed
# run: losses within TOL_CKPT_LOSS_REL, and parameters within the JAX
# package's gradient bars, but for at most WINDOW_OUTSIDE_SHARE of each
# parameter's entries: B3's and index_add_'s float atomics move a gradient
# in its last bits from run to run, and where a gradient is as small as that
# noise, Adam's normalised step flips its sign (a second run of single steps
# is compared with the first for scale). The gradient of a render with the
# key buffer at twice its entries against the exact buffer's, per parameter
# within TOL_BWD_REL of its largest value (the backward compositor's bar).
# (c) WINDOW_WARMUP windows, then WINDOW_TIMED timed ones, then one under
# the profiler.
WINDOW = 16
WINDOW_OUTSIDE_SHARE = 1e-3
WINDOW_WARMUP, WINDOW_TIMED = 2, 5
# Phase 14: the convergence proof's preset (24 views of 544x976, 2000 steps
# of the flagship and of the unpruned baseline), never cut; its bars are the
# tool's own.
CONVERGENCE_PRESET = "full"
# Phase 16: the one-program event sweeps. (b) the graph sweeps against the
# eager exact ones at N_VIEWS views: counts exact, scores within
# TOL_STATS_REL of the largest (B2's bar), the cull's degrees equal but
# where a statistic of the eager passes lies within DECISION_MARGIN of its
# threshold (thresholds that split the scene's Gaussians, from the eager
# statistics), and its features within TOL_SWEEP_FEATURES; the cull's
# timings use SHCuller's defaults. (c) times at each
# of SWEEP_VIEWS views: REPEATS runs at N_VIEWS, SWEEP_REPEATS at more, each
# after one warm-up. (d) a forced overflow from a key buffer of the largest
# view's entries / SWEEP_OVERFLOW_DIVISOR.
SWEEP_VIEWS = (N_VIEWS, 64)
SWEEP_REPEATS = 3
TOL_SWEEP_FEATURES = 1e-6
SWEEP_OVERFLOW_DIVISOR = 3
CULL_STD, CULL_CDIST = 0.04, 6.0


def log(msg):
    print(msg, flush=True)


def pool_mib(nbytes):
    """A graph's pool as printed: ``capture_graph`` sizes it only while a
    profiler records, and leaves None otherwise."""
    return "an unsized" if nbytes is None else f"{nbytes / 2**20:.1f} MiB of"


def bench_scene(seed=0, n=N_GAUSSIANS):
    """Raw parameters of the bench scene (bench.py's distribution) from numpy;
    ``n`` Gaussians (the bench scene's 200,000 by default)."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                          3.5 + rng.uniform(-1.5, 1.5, (n, 1))], axis=1)
    feats = rng.normal(0.0, 0.2, (n, 16, 3))
    params = dict(
        xyz=xyz,
        features_dc=feats[:, :1] + 0.4,
        features_rest=feats[:, 1:],
        scaling=rng.uniform(-5.5, -4.0, (n, 3)),
        rotation=rng.normal(0.0, 0.1, (n, 4)) + np.array([1.0, 0.0, 0.0, 0.0]),
        opacity=rng.uniform(-2.0, 2.0, (n, 1)))
    return {k: v.astype(np.float32) for k, v in params.items()}


def perturbed(params, seed=7):
    """bench.py's perturbation of the parameters (its gradient gate): the
    trained model starts here, the ground truth is the unperturbed scene."""
    rng = np.random.default_rng(seed)
    sigma = dict(xyz=0.01, features_dc=0.05, features_rest=0.02, scaling=0.1,
                 rotation=0.02, opacity=0.2)
    return {k: (v + sigma[k] * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in params.items()}


def view_poses():
    """COLMAP (qvec, tvec) of the views: small rotations about y and x and
    small translations around the origin."""
    poses = []
    for i in range(N_VIEWS):
        a = 0.03 * (i - (N_VIEWS - 1) / 2)
        b = 0.02 * ((i % 2) - 0.5)
        q = np.array([math.cos(a / 2) * math.cos(b / 2), math.sin(b / 2) * math.cos(a / 2),
                      math.sin(a / 2) * math.cos(b / 2), -math.sin(a / 2) * math.sin(b / 2)])
        q /= np.linalg.norm(q)
        poses.append((q, np.array([0.05 * (i - 1.5), 0.02 * (i % 2), 0.03 * i])))
    return poses


def view_camera(pose, dev, bg_color=(0.0, 0.0, 0.0)):
    """The HEIGHT x WIDTH camera at COLMAP pose (qvec, tvec)."""
    from reduced_3dgs_torch.dataset.camera import build_camera, focal2fov
    from reduced_3dgs_torch.dataset.colmap import qvec2rotmat
    q, t = pose
    return build_camera(HEIGHT, WIDTH, focal2fov(FOCAL_X, WIDTH), focal2fov(FOCAL_Y, HEIGHT),
                        R=qvec2rotmat(q).T, T=t, bg_color=bg_color, device=dev)


def cuda_ms(fn, warmup=3, setup=None, repeats=None):
    """Median milliseconds of fn() over `repeats` (REPEATS) runs, each
    between two CUDA events, after `warmup` runs; setup(), when given, runs
    before each run, outside the events."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    times = []
    for _ in range(repeats or REPEATS):
        if setup:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(fn, calls=5):
    """Profile `calls` calls of fn(): (device kernels and copies per call,
    device busy ms per call, wall ms per call, top kernels by device time,
    device ms per call of each kernel name). Busy is the sum of device
    kernel and copy times on the one stream; the shadows of the program's
    ``r3dgs.*`` regions on the device's timeline are no device work."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA
           and not a.key.startswith("r3dgs.")]
    busy_us = sum(a.self_device_time_total for a in dev)
    top = sorted(dev, key=lambda a: -a.self_device_time_total)[:6]
    by_name = {a.key: a.self_device_time_total / 1e3 / calls for a in dev}
    return (sum(a.count for a in dev) / calls, busy_us / 1e3 / calls, wall_ms / calls,
            [(a.key[:60], a.count // calls, a.self_device_time_total / 1e3 / calls)
             for a in top], by_name)


def kernel_device_ms(by_name, kernel):
    """Device ms per call of the kernels whose name holds `kernel`, from
    device_busy's last item."""
    return sum(ms for key, ms in by_name.items() if kernel in key)


def print_busy(card, what, stats):
    n_launch, busy_ms, wall_ms, top, _ = stats
    if busy_ms > 0:
        log(f"phase 5 [{card}]: under torch.profiler, per {what}: {n_launch:.0f} device "
            f"kernels and copies, device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
            f"(idle share {1 - busy_ms / wall_ms:.3f}); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
    else:
        log(f"phase 5: device busy share per {what} not measured (the profiler saw no "
            "device time)")


def sorted_entries(model, camera):
    """Preprocess, bin and gather: the compositor's inputs on the main path."""
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    from reduced_3dgs_torch.ops.rasterize.composite import pack_fields
    settings = model.render_settings(camera)
    tiles_x, tiles_y = common.tile_grid(settings)
    pre = common.preprocess(*model.render_array_args(), settings)
    ent = tiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths,
                             tiles_x, tiles_y)
    e = pack_fields(pre).index_select(1, ent["s_gidx"]).contiguous()
    return e, ent["range_start"], ent["range_end"], tiles_x, ent["num_rendered"], ent["s_gidx"]


def compare_compositor(name, model, camera):
    """Forward kernel against plain version on one scene; raises past the bars."""
    from reduced_3dgs_torch.ops.rasterize.composite import composite_fwd, composite_fwd_plain
    e, rs, re, tiles_x, k, s_gidx = sorted_entries(model, camera)
    kc, kt, kl = composite_fwd(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    pc, pt, pl = composite_fwd_plain(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    d_color = float((kc[..., :3] - pc[..., :3]).abs().max()) if k else 0.0
    d_depth = float((kc[..., 3] - pc[..., 3]).abs().max()) if k else 0.0
    d_t = float((kt - pt).abs().max())
    mismatch = int((kl != pl).sum())
    n_pix = kl.numel()
    latched = int((kl[..., 0] < re[:, None]).sum())
    empty = int((re == rs).sum())
    log(f"phase 3 [{name}]: num_rendered={k} empty_tiles={empty}/{rs.numel()} "
        f"latched_pixels={latched} max|d color|={d_color:.3e} max|d depth|={d_depth:.3e} "
        f"max|d final_T|={d_t:.3e} latch_mismatch={mismatch}/{n_pix} (bars: colour and "
        f"final_T {TOL_COLOR}, depth {TOL_DEPTH}, latch {MAX_LATCH_MISMATCH_SHARE:.0e} of pixels)")
    if not (d_color <= TOL_COLOR and d_t <= TOL_COLOR and d_depth <= TOL_DEPTH):
        raise AssertionError(f"{name}: composite_fwd disagrees with its plain version")
    if mismatch > MAX_LATCH_MISMATCH_SHARE * n_pix:
        raise AssertionError(f"{name}: {mismatch} latch mismatches of {n_pix} pixels")
    return dict(k=k, max_abs_err=max(d_color, d_depth, d_t), latched=latched, empty=empty,
                tiles=rs.numel(), inputs=(e, rs, re, tiles_x), latch=kl, final_t=kt,
                color4=kc, s_gidx=s_gidx, n=model.num_points)


def compare_stats(name, case):
    """The statistics compositor on the forward compositor's case: its
    colour, T and latch must equal the forward kernel's bit for bit, and its
    statistics its plain version's, per entry and per Gaussian: counts
    exactly outside the tiles whose latch differs between kernel and plain
    version, count x opacity there bit for bit per entry (both round
    float(count) * opacity once), each score within TOL_STATS_REL of its
    largest plain value. Raises past the bars."""
    from reduced_3dgs_torch.ops.rasterize.composite import (composite_fwd_stats,
                                                            composite_fwd_stats_plain)
    e, rs, re, tiles_x = case["inputs"]
    kc, kt, kl, ks = composite_fwd_stats(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    same = (torch.equal(kc, case["color4"]) and torch.equal(kt, case["final_t"])
            and torch.equal(kl, case["latch"]))
    pc, pt, pl, ps = composite_fwd_stats_plain(e, rs, re, tiles_x)
    torch.cuda.synchronize()
    K, n, s_gidx = e.shape[1], case["n"], case["s_gidx"]
    seg = torch.repeat_interleave(torch.arange(rs.numel(), device=e.device), re - rs,
                                  output_size=K)
    bad_tiles = (kl != pl).flatten(1).any(dim=1)
    ok = ~bad_tiles[seg]                                                  # [K]
    kn = torch.zeros((4, n), device=e.device).index_add_(1, s_gidx, ks)
    pn = torch.zeros((4, n), device=e.device).index_add_(1, s_gidx, ps)
    ok_g = torch.ones(n, dtype=torch.bool, device=e.device)
    ok_g[s_gidx[~ok]] = False
    count_diff = (int((ks[0] != ps[0])[ok].sum()), int((kn[0] != pn[0])[ok_g].sum()))
    count_op_diff = int((ks[1] != ps[1])[ok].sum())
    worst, max_abs, parts = 0.0, 0.0, []
    for level, kv, pv, sel in (("entry", ks, ps, ok), ("gaussian", kn, pn, ok_g)):
        for f in range(1, 4):
            d = float((kv[f] - pv[f])[sel].abs().max()) if bool(sel.any()) else 0.0
            scale = float(pv[f].abs().max()) if pv.shape[1] else 0.0
            if not math.isfinite(d):
                raise AssertionError(f"{name}: non-finite statistic {STAT_FIELDS[f]}")
            rel = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
            worst = max(worst, rel)
            if level == "entry":
                max_abs = max(max_abs, d)
            parts.append(f"{level}/{STAT_FIELDS[f]} {d:.2e}/{scale:.2e}")
    log(f"phase 3 [{name}]: composite_fwd_stats colour, T and latch equal to composite_fwd "
        f"bit for bit: {same}; tiles with a latch mismatch {int(bad_tiles.sum())}; count "
        f"mismatches outside them: {count_diff[0]} entries, {count_diff[1]} Gaussians "
        f"(of {K}, {n}); entries whose count x opacity differs in any bit: {count_op_diff}; "
        f"contributing pairs {int(ps[0].sum())}; max|d|/max|plain| per score: "
        + ", ".join(parts) + f"; worst ratio {worst:.3e} (bar {TOL_STATS_REL})")
    if not same:
        raise AssertionError(f"{name}: composite_fwd_stats composites otherwise than "
                             "composite_fwd")
    if count_diff != (0, 0) or count_op_diff != 0 or worst > TOL_STATS_REL:
        raise AssertionError(f"{name}: composite_fwd_stats disagrees with its plain version")
    return dict(max_abs_err=max_abs, stats=ks, per_gaussian=kn,
                contributing=int(ps[0].sum()))


def loss_cotangents(model, camera, gt):
    """(g_color4, g_T) of the training loss (0.8 L1 + 0.2 (1 - SSIM)) of
    `model` against `gt` at `camera`, through the port's forward pipeline,
    with the forward kernel's outputs as the leaves."""
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    from reduced_3dgs_torch.ops.ssim import ssim
    from reduced_3dgs_torch.utils.math import l1_loss
    settings = model.render_settings(camera)
    tiles_x, tiles_y = common.tile_grid(settings)
    e, rs, re, _, k, s_gidx = sorted_entries(model, camera)
    from reduced_3dgs_torch.ops.rasterize.composite import composite_fwd
    color4, final_t, latch = composite_fwd(e, rs, re, tiles_x)
    c4 = color4.clone().requires_grad_(True)
    ft = final_t.clone().requires_grad_(True)
    pre = common.preprocess(*model.render_array_args(), settings)
    with torch.enable_grad():
        img = tiled._assemble_outputs(c4, ft, pre, settings, tiles_x, tiles_y, HEIGHT, WIDTH,
                                      k)["render"]
        loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
        g_c4, g_t = torch.autograd.grad(loss, (c4, ft))
    return dict(inputs=(e, rs, re, tiles_x), final_t=final_t, latch=latch, s_gidx=s_gidx,
                n=model.num_points, k=k, g_color4=g_c4.contiguous(), g_t=g_t.contiguous())


def compare_backward(name, case, g_color4, g_t):
    """Backward kernel against plain version on the forward kernel's own
    buffers, per field, per entry [10,K] and per Gaussian [10,N]; and the
    kernel's per-Gaussian form (given the entries' Gaussian ids) against its
    per-entry form summed by index_add_ ("fused")."""
    from reduced_3dgs_torch.ops.rasterize.composite import (composite_bwd,
                                                            composite_bwd_per_gaussian,
                                                            composite_bwd_plain)
    e, rs, re, tiles_x = case["inputs"]
    args = (e, rs, re, tiles_x, case["final_t"], case["latch"], g_color4, g_t)
    kg = composite_bwd(*args)
    torch.cuda.synchronize()
    pg = composite_bwd_plain(*args)
    torch.cuda.synchronize()
    n = case["n"]
    fused = composite_bwd_per_gaussian(e, case["s_gidx"], n, *args[1:])
    kn = torch.zeros((10, n), device=e.device).index_add_(1, case["s_gidx"], kg)
    pn = torch.zeros((10, n), device=e.device).index_add_(1, case["s_gidx"], pg)
    worst, max_abs = 0.0, 0.0
    parts = []
    for level, (kv, pv) in (("entry", (kg, pg)), ("gaussian", (kn, pn)),
                            ("fused", (fused, kn))):
        for f, fname in enumerate(FIELDS):
            if kv.shape[1] == 0:
                d = scale = 0.0
            else:
                d = float((kv[f] - pv[f]).abs().max())
                scale = float(pv[f].abs().max())
            if not math.isfinite(d):
                raise AssertionError(f"{name}: non-finite backward gradient in {fname}")
            rel = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
            worst = max(worst, rel)
            if level == "entry":
                max_abs = max(max_abs, d)
            parts.append(f"{level}/{fname} {d:.2e}/{scale:.2e}")
    log(f"phase 3 [{name}]: composite_bwd vs plain (fused: the per-Gaussian form vs the "
        f"per-entry form summed by index_add_), max|d|/max|plain| per field: "
        + ", ".join(parts) + f"; worst ratio {worst:.3e} (bar {TOL_BWD_REL})")
    if worst > TOL_BWD_REL:
        raise AssertionError(f"{name}: composite_bwd disagrees with its plain version")
    return dict(max_abs_err=max_abs, grads=kg, plain=pg, per_gaussian=fused)


def backward_pairs(e, range_start, range_end, tiles_x, latch):
    """(pairs, contributing) of the backward compositor on these inputs:
    the (pixel, entry) pairs before each pixel's latch, whose gate it must
    evaluate, and those of them that pass the gate (power <= 0 and
    alpha >= 1/255) and so take the gradient arithmetic. Counted on the
    card in chunks of 32 pixels, as composite_bwd_plain selects them."""
    from reduced_3dgs_torch import config
    K, T = e.shape[1], range_start.numel()
    rs, re = range_start.long(), range_end.long()
    lat = latch[..., 0].long()                                          # [T,256]
    pairs = int((lat - rs[:, None]).clamp(min=0).sum())
    seg = torch.repeat_interleave(torch.arange(T, device=e.device), re - rs, output_size=K)
    pos = torch.arange(K, device=e.device)
    tile_x = ((seg % tiles_x) * config.BLOCK_X).float()
    tile_y = ((seg // tiles_x) * config.BLOCK_Y).float()
    x, y, A, B, C, op = e[:6]
    contributing = 0
    for p0 in range(0, config.BLOCK_SIZE, 32):
        p = torch.arange(p0, p0 + 32, device=e.device)[:, None]
        dx = x - (tile_x + (p % config.BLOCK_X).float())
        dy = y - (tile_y + (p // config.BLOCK_X).float())
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=config.ALPHA_MAX)
        live = (power <= 0.0) & (alpha >= config.ALPHA_EPS) & (pos < lat[:, p0:p0 + 32].T[:, seg])
        contributing += int(live.sum())
    return pairs, contributing


def check_ssim_gradient(img, gt):
    """The SSIM gradient on the card in float32 against the same float32
    arithmetic on the CPU, where no convolution runs in TF32. float32 itself
    is some 1e-5 to 1e-4 of the gradient's scale away from float64 (SSIM's
    variances are differences of nearly equal moments), so the bar is on the
    card-vs-CPU gap, which is what TF32 would widen; the float64 gaps of
    both are printed beside it."""
    from reduced_3dgs_torch.ops.ssim import ssim

    def grad(x, y):
        x = x.detach().clone().requires_grad_(True)
        ssim(x, y).backward()
        return x.grad

    g_card = grad(img, gt)
    g64 = grad(img.double(), gt.double())
    g_cpu = grad(img.cpu(), gt.cpu()).to(img.device)
    scale = g64.abs().max()

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / scale)

    card_cpu = rel(g_card, g_cpu)
    log(f"phase 3: SSIM gradient, max|d| / max|g float64| ({float(scale):.3e}): card float32 "
        f"vs CPU float32 {card_cpu:.3e} (bar {TOL_SSIM_GRAD_REL}); card float32 vs float64 "
        f"{rel(g_card, g64):.3e}; CPU float32 vs float64 {rel(g_cpu, g64):.3e}")
    if not card_cpu <= TOL_SSIM_GRAD_REL:
        raise AssertionError(f"SSIM gradient on the card off by {card_cpu:.3e} of its scale")
    return card_cpu


def write_dataset(model, src, dst, cameras, poses):
    """COLMAP text model, ground-truth PNGs rendered by the port, and the PLY."""
    from PIL import Image
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(src, "images"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {WIDTH} {HEIGHT} {FOCAL_X!r} {FOCAL_Y!r} {WIDTH / 2} {HEIGHT / 2}\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("1 0.0 0.0 3.5 128 128 128 0.1\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for i, ((q, t), cam) in enumerate(zip(poses, cameras)):
            name = f"view{i}.png"
            f.write(f"{i + 1} {' '.join(map(repr, q.tolist()))} "
                    f"{' '.join(map(repr, t.tolist()))} 1 {name}\n0.0 0.0 -1\n")
            with torch.no_grad():
                img = torch.clamp(model(cam)["render"], 0, 1)
            arr = (img * 255).to(torch.uint8).cpu().numpy().transpose(1, 2, 0)
            Image.fromarray(arr).save(os.path.join(src, "images", name))
    model.save_ply(os.path.join(dst, "point_cloud", "iteration_1", "point_cloud.ply"))


def write_depths(model, src, cameras):
    """depths/view{i}.npy beside the dataset's images: depth / (1 - final_T)
    of `model`'s render at each camera, 0 where final_T > 0.5."""
    os.makedirs(os.path.join(src, "depths"))
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            out = model(cam)
        t = out["final_T"]
        depth = torch.where(t > 0.5, torch.zeros_like(t),
                            out["depth"] / torch.clamp(1.0 - t, min=1e-6))
        np.save(os.path.join(src, "depths", f"view{i}.npy"), depth.cpu().numpy())


def mean_gradient(engine):
    """[N] mean screen-space gradient over the steps that saw each Gaussian,
    as SplitCloneDensifier computes it."""
    denom = engine.xyz_grad_denom
    return torch.where(denom > 0, engine.xyz_grad_accum / torch.clamp(denom, min=1), 0.0)


def sample(x, size=100_000):
    """At most `size` entries of x, drawn without replacement (a fixed
    generator), for torch.quantile."""
    gen = torch.Generator(device=x.device).manual_seed(0)
    return x[torch.randperm(x.numel(), device=x.device, generator=gen)[:size]]


def densification_phase(card, model, params_p, src, cameras, wrappers, tmp, step_ms):
    """Phase 8: train.training() with SHCullingOpacityResetDensificationTrainer
    for DENSIFY_STEPS steps on the 4 views with ground-truth depths, checking
    each event (N, row counts, appended rows, the reset, the cull), the
    kernels' launch counts, and the backward compositor's depth and final_T
    cotangents. Returns the launch counts."""
    from reduced_3dgs_torch.combinations import SHCullingOpacityResetDensificationTrainer
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.ops.rasterize import composite
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.train import training
    from reduced_3dgs_torch.trainer import DepthTrainerWrapper, Trainer

    dev = torch.device("cuda")
    write_depths(model, src, cameras)
    dataset = prepare_dataset(src)
    if any(cam.ground_truth_depth is None for cam in dataset):
        raise AssertionError("prepare_dataset did not load every view's depth")
    extent = dataset.scene_extent()
    largest = np.exp(params_p["scaling"]).max(axis=1)
    calib_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    calib = DepthTrainerWrapper(Trainer, calib_model, dataset,
                                sh_degree_up_interval=DENSIFY_CONFIG["sh_degree_up_interval"])
    training(dataset, calib_model, calib, None, os.path.join(tmp, "calibration"),
             iteration=DENSIFY_CONFIG["densify_from_iter"], save_iterations=[])
    config = dict(DENSIFY_CONFIG,
                  densify_grad_threshold=float(torch.quantile(
                      sample(mean_gradient(calib.engine)), 1.0 - HOT_SHARE)),
                  densify_percent_dense=float(np.quantile(largest, CLONE_SCALE_QUANTILE)) / extent,
                  prune_percent_too_big=float(np.quantile(largest, BIG_SCALE_QUANTILE))
                  / (0.1 * extent))
    del calib, calib_model
    dmodel = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    trainer = SHCullingOpacityResetDensificationTrainer(dmodel, dataset, **config)
    densifying = trainer.base_trainer.base_trainer.base_trainer   # DensificationTrainer
    split = densifying.densifier.base_densifier
    k = split.densify_n_split
    log(f"phase 8: {len(dataset)} views with depth, scene extent {extent:.6f}; split/clone "
        f"grad threshold {split.densify_grad_threshold:.8f} (calibrated), clone at or below scale "
        f"{split.densify_percent_dense * extent:.6f}, prune above scale "
        f"{0.1 * config['prune_percent_too_big'] * extent:.6f}, screen radius "
        f"{densifying.densifier.prune_screensize_threshold}, opacity "
        f"{densifying.densifier.prune_opacity_threshold}")

    # Observation only: the instructions applied, the densify decisions'
    # gradient quantiles, and the backward compositor's cotangents.
    instructions, grad_quantiles, cotangents = {}, {}, []
    apply = densifying.apply_instruction
    split_fn = split.densify_and_prune
    backward = composite.CompositeSorted.backward

    def record_apply(instruction):
        instructions[trainer.curr_step] = (dmodel.num_points, instruction)
        return apply(instruction)

    def record_split(loss, out, camera, step):
        if split.fires(step):
            grad_quantiles[step] = torch.quantile(sample(mean_gradient(trainer.engine)),
                                                  torch.tensor([0.5, 0.9, 0.99], device=dev))
        return split_fn(loss, out, camera, step)

    def record_backward(ctx, g_color4, g_t):
        # The cotangents the backward compositor receives.
        cotangents.append(torch.stack([g_color4[..., 3].abs().amax(), g_t.abs().amax()]))
        return backward(ctx, g_color4, g_t)

    densifying.apply_instruction = record_apply
    split.densify_and_prune = record_split
    composite.CompositeSorted.backward = staticmethod(record_backward)

    events, step_events = [], []
    take_step = trainer.step
    watched = set(SPLIT_STEPS + DPRUNE_STEPS + RESET_STEPS + DCULL_STEPS)

    def step_and_watch(camera):
        fires = trainer.curr_step + 1 in watched
        if fires:
            n0 = dmodel.num_points
            hist0 = torch.bincount(dmodel._degrees.long(), minlength=4).tolist()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = take_step(camera)
        end.record()
        step_events.append((trainer.curr_step, start, end))
        if fires:
            engine = trainer.engine
            trees = engine.state_trees()
            events.append(dict(
                step=trainer.curr_step, n_before=n0, n_after=dmodel.num_points,
                degrees_before=hist0,
                degrees_after=torch.bincount(dmodel._degrees.long(), minlength=4).tolist(),
                rows=sorted({v.shape[0] for t in trees.values() for v in t.values()}),
                degrees=dmodel._degrees.clone(),
                moments={g: {n: v.abs().amax(dim=tuple(range(1, v.dim()))) for n, v in
                             trees[g].items()} for g in ("adam_m", "adam_v")},
                stats=[v.clone() for v in trees["accum"].values()],
                max_opacity=float(torch.sigmoid(dmodel._opacity.detach()).max()),
                opacity_moments=float(engine.adam.m["opacity"].abs().max()
                                      + engine.adam.v["opacity"].abs().max())))
        return out

    trainer.step = step_and_watch
    out_dir = os.path.join(tmp, "densify")
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        losses = training(dataset, dmodel, trainer, None, out_dir, iteration=DENSIFY_STEPS,
                          save_iterations=[])
        torch.cuda.synchronize()
    finally:
        composite.CompositeSorted.backward = staticmethod(backward)
        trainer.step, split.densify_and_prune = take_step, split_fn
        densifying.apply_instruction = apply
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    values = torch.stack(losses).cpu().tolist()
    step_times = {s: a.elapsed_time(b) for s, a, b in step_events}
    for s, q in sorted(grad_quantiles.items()):
        log(f"phase 8: before the densify after step {s}: mean screen-space gradient "
            f"quantiles 0.5/0.9/0.99 of a 100k sample {[round(v, 8) for v in q.tolist()]}")

    # Each event: its counts and its checks.
    failures = []
    for ev in events:
        s = ev["step"]
        n_pre, ins = instructions.get(s, (ev["n_before"], None))
        clones = splits = prunes = 0
        if ins is not None and ins.appends:
            clone_sel, split_sel = ins.appends[0].select, ins.appends[1].select
            clones, splits = int(clone_sel.sum()), int(split_sel.sum())
            if ins.remove_mask is not None:
                prunes = int((ins.remove_mask & ~split_sel).sum())
        elif ins is not None and ins.remove_mask is not None:
            prunes = int(ins.remove_mask.sum())
        added = clones + k * splits
        log(f"phase 8: after step {s} ({step_times[s]:.4f} ms): N {ev['n_before']} -> "
            f"{ev['n_after']}; clones {clones}, splits {splits} (x{k}), prunes {prunes}; "
            f"degrees 0-3 {ev['degrees_before']} -> {ev['degrees_after']}; rows of every "
            f"per-Gaussian tensor {ev['rows']}; max sigmoid(opacity) {ev['max_opacity']:.8f}")
        if ev["rows"] != [ev["n_after"]]:
            failures.append(f"step {s}: per-Gaussian tensors have rows {ev['rows']}")
        if s in SPLIT_STEPS + DPRUNE_STEPS:
            if ev["n_after"] != ev["n_before"] + clones + (k - 1) * splits - prunes:
                failures.append(f"step {s}: N {ev['n_after']} is not N + clones + "
                                f"(k-1) splits - prunes")
        if s in SPLIT_STEPS:
            new = slice(ev["n_after"] - added, ev["n_after"])
            fresh = (bool((ev["degrees"][new] == 3).all())
                     and all(not bool(v[new].any()) for g in ev["moments"].values()
                             for v in g.values())
                     and all(not bool(v.any()) for v in ev["stats"]))
            if not (ev["n_after"] > ev["n_before"] and clones > 0 and splits > 0):
                failures.append(f"step {s}: the densify did not clone, split and raise N")
            if not fresh:
                failures.append(f"step {s}: appended rows are not at degree 3 with zero "
                                "moments and statistics")
        if s == DPRUNE_STEPS[0] and prunes == 0:
            failures.append(f"step {s}: the first prune removed nothing")
        if s in RESET_STEPS and not (ev["max_opacity"] <= DENSIFY_CONFIG["opacity_reset_value"]
                                     * (1 + RESET_TOL_REL) and ev["opacity_moments"] == 0):
            failures.append(f"step {s}: the opacity reset left opacity {ev['max_opacity']} "
                            f"or moments {ev['opacity_moments']}")
        if s in DCULL_STEPS and not sum(ev["degrees_after"][:3]) > sum(ev["degrees_before"][:3]):
            failures.append(f"step {s}: the cull lowered no degree")
    ordinary = statistics.median(t for s, t in step_times.items() if s not in watched)
    cot = torch.stack(cotangents).cpu()
    log(f"phase 8 [{card}]: training() {DENSIFY_STEPS} steps in {wall:.2f} s; N "
        f"{N_GAUSSIANS} -> {dmodel.num_points}; median ordinary step {ordinary:.4f} ms; event "
        "steps " + ", ".join(f"{s} {step_times[s]:.4f} ms ({step_times[s] / ordinary:.2f}x)"
                             for s in sorted(watched))
        + f"; losses {values}; launches {launches}; backward compositor cotangents, min over "
        f"the steps of max|g depth| {float(cot[:, 0].min()):.3e} and of max|g final_T| "
        f"{float(cot[:, 1].min()):.3e}")
    expected = {"composite_fwd": DENSIFY_STEPS, "composite_bwd": DENSIFY_STEPS,
                "composite_fwd_stats": 2 * len(dataset) * len(DCULL_STEPS)}
    if launches != expected:
        failures.append(f"densification path launched {launches}, expected {expected}")
    if [ev["step"] for ev in events] != sorted(watched):
        failures.append(f"events watched after steps {[ev['step'] for ev in events]}")
    if len(cot) != DENSIFY_STEPS or not bool((cot > 0).all()):
        failures.append("the backward compositor saw a zero depth or final_T cotangent: "
                        f"{cot.tolist()}")
    if len(values) != DENSIFY_STEPS or not all(map(math.isfinite, values)):
        failures.append(f"densification losses are not all finite: {values}")
    saved = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(out_dir, "point_cloud", f"iteration_{DENSIFY_STEPS}", "point_cloud.ply"))
    log(f"phase 8: saved PLY holds {saved.num_points} points (model {dmodel.num_points})")
    if saved.num_points != dmodel.num_points:
        failures.append("the saved PLY does not hold the densified model")
    if failures:
        raise AssertionError("phase 8: " + "; ".join(failures))

    # The step at the grown N, against phase 5's step at the bench scene.
    cam = dataset[0]
    grown_ms = cuda_ms(lambda: trainer.step(cam))
    log(f"phase 8 [{card}]: training step at N={dmodel.num_points} with the depth term "
        f"{grown_ms:.4f} ms against {step_ms:.4f} ms at N={N_GAUSSIANS} (phase 5, Trainer.step)")
    return launches, config


def clustered_cloud(n, seed=0):
    """A copy of tools/knn_recall.py's cloud: ~200 anisotropic Gaussian
    clusters (85% of the points) and a uniform background over a 10x larger
    extent, about 1000x density contrast, shuffled."""
    rng = np.random.default_rng(seed)
    n_bg = n // 7
    n_cl = n - n_bg
    n_clusters = 200
    centers = rng.uniform(-10, 10, (n_clusters, 3))
    sizes = rng.dirichlet(np.full(n_clusters, 0.5)) * n_cl
    sizes = np.maximum(sizes.astype(np.int64), 1)
    sizes[0] += n_cl - sizes.sum()
    pts = []
    for c, s in zip(centers, sizes):
        scale = 10 ** rng.uniform(-2.5, -0.5, 3)
        pts.append(c + rng.normal(0, 1, (s, 3)) * scale)
    pts.append(rng.uniform(-100, 100, (n_bg, 3)))
    cloud = np.concatenate(pts).astype(np.float32)
    return rng.permutation(cloud)


def pair_sq_dist(a, b):
    """[A, B] squared distances of a [A,3] and b [B,3], summed x, y, z."""
    d = a[:, None, 0] - b[None, :, 0]
    acc = d * d
    d = a[:, None, 1] - b[None, :, 1]
    acc += d * d
    d = a[:, None, 2] - b[None, :, 2]
    return acc + d * d


def exact_knn(points, rows, k, chunk=512):
    """(squared distances, ids) [len(rows), k] of the exact k nearest
    neighbours of points[rows], themselves excluded: plain torch, row chunks
    against the whole cloud."""
    ds, ids = [], []
    for r0 in range(0, rows.numel(), chunk):
        r = rows[r0:r0 + chunk]
        d = pair_sq_dist(points[r], points)
        d[torch.arange(r.numel(), device=points.device), r] = float("inf")
        v, i = torch.topk(d, k, dim=1, largest=False)
        ds.append(v)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids)


def recall_at_k(ids, oracle_ids):
    """Share of the oracle's neighbours that `ids` (same rows) holds."""
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(), oracle_ids.tolist()))
    return hits / oracle_ids.numel()


def knn_phase(card, params):
    """Phase 9 (a): knn(k=30) on the bench scene's centres and on the
    clustered cloud, timed, with recall@30 on RECALL_QUERIES queries, and
    mean_knn_dist_sq against the exact two nearest neighbours."""
    from reduced_3dgs_torch.ops.knn import knn, mean_knn_dist_sq
    dev = torch.device("cuda")
    recalls = {}
    for name, pts in (("bench centres", params["xyz"]),
                      ("clustered cloud", clustered_cloud(CLUSTER_POINTS, 0))):
        p = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        n = p.shape[0]
        ms = cuda_ms(lambda: knn(p, KNN_K), warmup=1, repeats=PHASE9_REPEATS)
        d, ids = knn(p, KNN_K)
        rows = torch.from_numpy(np.sort(np.random.default_rng(1).choice(
            n, RECALL_QUERIES, replace=False))).to(dev)
        _, oracle = exact_knn(p, rows, KNN_K)
        recalls[name] = recall_at_k(ids[rows], oracle)
        log(f"phase 9 [{card}]: knn(k={KNN_K}) on the {name}, N={n}: {ms:.4f} ms (median of "
            f"{PHASE9_REPEATS} after a warm-up); recall@{KNN_K} against the exact oracle on "
            f"{RECALL_QUERIES} queries {recalls[name]:.6f} (bar {MIN_RECALL}); empty slots "
            f"{int((ids < 0).sum())}, finite distances {bool(torch.isfinite(d).all())}")
        del p, d, ids
    p = torch.from_numpy(params["xyz"]).to(dev)
    ms = cuda_ms(lambda: mean_knn_dist_sq(p), warmup=1, repeats=PHASE9_REPEATS)
    approx = mean_knn_dist_sq(p)
    exact_d, _ = exact_knn(p, torch.arange(p.shape[0], device=dev), 2)
    exact = (exact_d[:, 0] + exact_d[:, 1]) / 3.0
    rel = (approx - exact) / exact
    log(f"phase 9 [{card}]: mean_knn_dist_sq on the bench centres {ms:.4f} ms; against the "
        f"exact two nearest neighbours: relative error max {float(rel.max()):.6e}, median "
        f"{float(rel.median()):.6e}, rows off by more than 1e-6 {int((rel.abs() > 1e-6).sum())} "
        f"of {p.shape[0]}")
    if not bool(torch.isfinite(approx).all()) or float(rel.min()) < -1e-5:
        raise AssertionError("mean_knn_dist_sq is not finite or lies below the exact value")
    low = {k: v for k, v in recalls.items() if not v >= MIN_RECALL}
    if low:
        raise AssertionError(f"knn recall@{KNN_K} below {MIN_RECALL}: {low}")


def write_colmap_binary(root, xyz, rgb, poses):
    """A binary COLMAP model under root/sparse/0: one PINHOLE camera of the
    bench views, the views at `poses`, and the points with their colours."""
    import struct
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, WIDTH, HEIGHT))
        f.write(struct.pack("<dddd", FOCAL_X, FOCAL_Y, WIDTH / 2, HEIGHT / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (q, t) in enumerate(poses):
            f.write(struct.pack("<i4d3di", i + 1, *q.tolist(), *t.tolist(), 1)
                    + f"view{i}.png".encode() + b"\0" + struct.pack("<Q", 0))
    record = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8"),
                       ("track", "<u8")])
    points = np.zeros(len(xyz), record)
    points["id"] = np.arange(1, len(xyz) + 1)
    points["xyz"], points["rgb"] = xyz, rgb
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(points.tobytes())


def colmap_init_phase(card, params, tmp):
    """Phase 9 (b): colmap_init from a binary COLMAP dataset holding the
    bench scene's centres and DC colours."""
    from reduced_3dgs_torch.dataset import colmap_init
    from reduced_3dgs_torch.ops.sh import SH_C0
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    src = os.path.join(tmp, "colmap_binary")
    rgb = np.clip((params["features_dc"][:, 0] * SH_C0 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    write_colmap_binary(src, params["xyz"], rgb, view_poses())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = colmap_init(VariableSHGaussianModel(3, device=torch.device("cuda")), src)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    scales = model._scaling.detach()
    finite = all(bool(torch.isfinite(v).all()) for v in model.param_dict().values())
    log(f"phase 9 [{card}]: colmap_init of {model.num_points} points from points3D.bin in "
        f"{seconds:.3f} s; scene extent {model.spatial_lr_scale:.6f}; log scale min "
        f"{float(scales.min()):.4f}, median {float(scales.median()):.4f}, max "
        f"{float(scales.max()):.4f}; every parameter finite {finite}")
    if model.num_points != N_GAUSSIANS or not finite:
        raise AssertionError("colmap_init did not give the dataset's points with finite "
                             "parameters")
    if not torch.equal(model._xyz.detach().cpu(), torch.from_numpy(params["xyz"])):
        raise AssertionError("colmap_init moved the centres")


def mercy_decisions(model, views, box_size):
    """Float64 inputs of the mercy event's decisions, from the port's own
    pixel sizes and neighbours: (quadratic forms [N,30], counts, threshold,
    opacity, median) of the default type, lambda 1, minimum 3."""
    from reduced_3dgs_torch.ops.knn import knn
    from reduced_3dgs_torch.ops.projection import quat_to_rotmat
    from reduced_3dgs_torch.pruning.trainer import (camera_matrices, masked_median,
                                                    redundancy_minimum)
    from reduced_3dgs_torch.ops.redundancy import find_minimum_projected_pixel_size
    xyz = model._xyz.detach()
    full, inv, hs, ws = camera_matrices(views)
    radius = (find_minimum_projected_pixel_size(full, inv, xyz, hs, ws) * box_size
              * math.sqrt(3.0) / 2.0).double()
    _, ids = knn(xyz, KNN_K)
    x64 = xyz.double()
    safe = ids.clamp(min=0)
    local = torch.einsum("nki,nij->nkj", x64[:, None, :] - x64[safe],
                         quat_to_rotmat(model.get_rotation.detach().double()))
    aug = model.get_scaling.detach().double()[safe] + radius[:, None, None]
    q = torch.sum(local * local / (aug * aug), dim=-1)
    q = torch.where(ids >= 0, q, torch.full_like(q, math.inf))
    counts = redundancy_minimum(ids, q < 1).double()
    threshold = max(float(counts.mean() + counts.std()), 3.0)
    opacity = torch.sigmoid(model._opacity.detach()[:, 0])
    median = float(masked_median(opacity, counts > threshold))
    return q, counts, threshold, opacity, median


def near(values, threshold):
    """How many of `values` lie within DECISION_MARGIN (relative) of
    `threshold` without equalling it."""
    if not math.isfinite(threshold):
        return 0
    d = (values.double() - threshold).abs()
    return int(((d > 0) & (d <= DECISION_MARGIN * max(abs(threshold), 1e-12))).sum())


def mercy_phase(card, params, poses):
    """Phase 9 (c): one mercy event at the bench scene over the 4 views,
    timed whole and by stage, under the profiler, and on a subset against
    the same event on the CPU."""
    from reduced_3dgs_torch.dataset.dataset import CameraDataset
    from reduced_3dgs_torch.ops.knn import knn
    from reduced_3dgs_torch.ops.redundancy import (find_minimum_projected_pixel_size,
                                                   sphere_ellipsoid_intersection)
    from reduced_3dgs_torch.pruning.trainer import (camera_matrices, mercy_gaussians,
                                                    mercy_policy, redundancy_minimum)
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    dev = torch.device("cuda")
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    views = CameraDataset([view_camera(pose, dev) for pose in poses])
    with torch.no_grad():
        event_ms = cuda_ms(lambda: mercy_gaussians(model, views), warmup=1,
                           repeats=PHASE9_REPEATS)
        removed = int(mercy_gaussians(model, views).sum())
        xyz, scaling = model._xyz.detach(), model.get_scaling.detach()
        rotation = model.get_rotation.detach()
        opacity = torch.sigmoid(model._opacity.detach()[:, 0])
        state = {}

        def pixel():
            full, inv, hs, ws = camera_matrices(views)
            state["radius"] = (find_minimum_projected_pixel_size(full, inv, xyz, hs, ws)
                               * 1.0 * math.sqrt(3.0) / 2.0)

        def neighbours():
            state["ids"] = knn(xyz, KNN_K)[1]

        def intersection():
            state["mask"] = sphere_ellipsoid_intersection(xyz, scaling, rotation, state["ids"],
                                                          state["radius"])[1]

        def segment_min():
            state["counts"] = redundancy_minimum(state["ids"], state["mask"])

        def policy():
            state["removal"] = mercy_policy(state["counts"], opacity, 1.0, 3,
                                            "redundancy_opacity")

        stages = {name: cuda_ms(fn, warmup=1, repeats=PHASE9_REPEATS) for name, fn in (
            ("pixel size", pixel), ("knn", neighbours), ("intersection", intersection),
            ("segment-min", segment_min), ("policy", policy))}
        if int(state["removal"].sum()) != removed:
            raise AssertionError("the mercy stages disagree with mercy_gaussians")
        busy = device_busy(lambda: mercy_gaussians(model, views), calls=3)
    counts = state["counts"].double()
    log(f"phase 9 [{card}]: mercy event (mercy_gaussians, box 1, lambda 1, minimum 3, "
        f"redundancy_opacity) over {len(views)} views at N={model.num_points}: "
        f"{event_ms:.4f} ms (median of {PHASE9_REPEATS}); stages "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items())
        + f"; removes {removed}; redundancy counts mean {float(counts.mean()):.4f}, std "
        f"{float(counts.std()):.4f}, max {int(counts.max())}")
    n_launch, busy_ms, wall_ms, top, _ = busy
    if busy_ms > 0:
        log(f"phase 9 [{card}]: under torch.profiler, per mercy event: {n_launch:.0f} device "
            f"kernels and copies, device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall (idle "
            f"share {1 - busy_ms / wall_ms:.3f}); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
    else:
        log("phase 9: the mercy event's idle share not measured (the profiler saw no device "
            "time)")
    del model, state

    # The subset on the card and on the CPU.
    sub_rows = np.argsort(params["xyz"][:, 0], kind="stable")[:MERCY_SUBSET]
    sub = {k: v[sub_rows] for k, v in params.items()}
    cpu = torch.device("cpu")
    card_model = VariableSHGaussianModel(3, device=dev).load_numpy(sub)
    cpu_model = VariableSHGaussianModel(3, device=cpu).load_numpy(sub)
    cpu_views = CameraDataset([view_camera(pose, cpu) for pose in poses])
    failures = []
    for box in MERCY_BOXES:
        with torch.no_grad():
            card_mask = mercy_gaussians(card_model, views, box_size=box).cpu()
            cpu_mask = mercy_gaussians(cpu_model, cpu_views, box_size=box)
            q, counts, threshold, opacity, median = mercy_decisions(cpu_model, cpu_views, box)
            card_ids = knn(card_model._xyz.detach(), KNN_K)[1].cpu()
            cpu_ids = knn(cpu_model._xyz.detach(), KNN_K)[1]
        same_sets = sum(set(a) == set(b) for a, b in zip(card_ids.tolist(), cpu_ids.tolist()))
        log(f"phase 9 [{card}]: mercy on the {MERCY_SUBSET}-Gaussian subset, box {box}: card "
            f"removes {int(card_mask.sum())}, CPU {int(cpu_mask.sum())}, masks equal "
            f"{torch.equal(card_mask, cpu_mask)}; neighbour sets equal on {same_sets} of "
            f"{MERCY_SUBSET} rows; threshold {threshold:.6f}, redundant "
            f"{int((counts > threshold).sum())}, median opacity {median:.6f}; decisions within "
            f"{DECISION_MARGIN} of their threshold: quadratic forms {near(q, 1.0)}, counts "
            f"{near(counts, threshold)}, opacities {near(opacity, median)}")
        if not torch.equal(card_mask, cpu_mask):
            failures.append(f"box {box}: the card's mask differs from the CPU's on "
                            f"{int((card_mask != cpu_mask).sum())} rows")
    if failures:
        raise AssertionError("phase 9 mercy: " + "; ".join(failures))


def flagship_phase(card, params_p, src, wrappers, tmp, dense_config):
    """Phase 9 (d): train.training() with the flagship trainer for
    FLAGSHIP_STEPS steps from phase 8's start and calibration; checks every
    event's N bookkeeping, the mercy event and the launch counts. Returns
    the launch counts and the median ordinary step in ms."""
    from reduced_3dgs_torch.combinations import (
        SHCullingOpacityResetFullReducedDensificationTrainer)
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.pruning import trainer as pruning_trainer
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.train import training

    dev = torch.device("cuda")
    dataset = prepare_dataset(src)
    if any(cam.ground_truth_depth is None for cam in dataset):
        raise AssertionError("prepare_dataset did not load every view's depth")
    config = dict(FLAGSHIP_CONFIG, **{k: dense_config[k] for k in (
        "densify_grad_threshold", "densify_percent_dense", "prune_percent_too_big")})
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    trainer = SHCullingOpacityResetFullReducedDensificationTrainer(model, dataset, **config)
    densifying = trainer.base_trainer.base_trainer.base_trainer
    pruner = densifying.densifier
    log(f"phase 9: flagship onion: {type(trainer).__name__} > "
        f"{type(trainer.base_trainer).__name__} > "
        f"{type(trainer.base_trainer.base_trainer).__name__} > {type(densifying).__name__}("
        f"{type(densifying.base_trainer).__name__}, {type(pruner).__name__} > "
        f"{type(pruner.base_densifier).__name__} > "
        f"{type(pruner.base_densifier.base_densifier).__name__}); mercy box "
        f"{pruner.box_size}, lambda {pruner.lambda_mercy}, minimum {pruner.mercy_minimum}, "
        f"{pruner.mercy_type}")

    # Observation only: each instruction, each mercy event and the first
    # mercy event's model.
    instructions, mercy_events, first_state = {}, [], {}
    apply = densifying.apply_instruction
    mercy_fn = pruning_trainer.mercy_gaussians

    def record_apply(instruction):
        if instruction.remove_mask is not None or instruction.appends:
            removed = (0 if instruction.remove_mask is None
                       else int(instruction.remove_mask.sum()))
            added = sum(int(sp.select.sum()) * sp.copies for sp in instruction.appends)
            instructions[trainer.curr_step] = (model.num_points, added, removed)
        return apply(instruction)

    def record_mercy(m, *args, **kwargs):
        if not first_state:
            first_state.update({k: v.detach().clone() for k, v in m.param_dict().items()})
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mask = mercy_fn(m, *args, **kwargs)
        end.record()
        mercy_events.append((trainer.curr_step, m.num_points, mask, start, end))
        return mask

    step_events = []
    take_step = trainer.step

    def timed_step(camera):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = take_step(camera)
        end.record()
        step_events.append((trainer.curr_step, start, end))
        return out

    densifying.apply_instruction = record_apply
    pruning_trainer.mercy_gaussians = record_mercy
    trainer.step = timed_step
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        losses = training(dataset, model, trainer, None, os.path.join(tmp, "flagship"),
                          iteration=FLAGSHIP_STEPS, save_iterations=[])
        torch.cuda.synchronize()
    finally:
        pruning_trainer.mercy_gaussians = mercy_fn
        densifying.apply_instruction = apply
        trainer.step = take_step
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    values = torch.stack(losses).cpu().tolist()
    step_times = {s: a.elapsed_time(b) for s, a, b in step_events}
    events = sorted(set(F_SPLIT + F_PRUNE + F_IMPORTANCE + F_CULL + F_RESET))
    ordinary = statistics.median(t for s, t in step_times.items() if s not in events)

    failures = []
    ordered = sorted(instructions.items())
    next_n = [v[0] for _, v in ordered][1:] + [model.num_points]
    for (s, (n_before, added, removed)), n_after in zip(ordered, next_n):
        log(f"phase 9: after step {s} ({step_times[s]:.4f} ms, {step_times[s] / ordinary:.2f}x "
            f"the median ordinary step): N {n_before} -> {n_after}, appended {added}, removed "
            f"{removed} (the OR of the removal masks)")
        if n_after != n_before + added - removed:
            failures.append(f"step {s}: N {n_before} + appended {added} - removed {removed} is "
                            f"not the next N {n_after}")
    if sorted(instructions) != sorted(set(F_SPLIT + F_PRUNE + F_IMPORTANCE)):
        failures.append(f"instructions after steps {sorted(instructions)}")
    for s, n, mask, start, end in mercy_events:
        log(f"phase 9: mercy event after step {s}: N {n}, removes {int(mask.sum())}, "
            f"{start.elapsed_time(end):.4f} ms")
    if [e[0] for e in mercy_events] != list(F_PRUNE):
        failures.append(f"mercy events after steps {[e[0] for e in mercy_events]}")
    first_removed = int(mercy_events[0][2].sum()) if mercy_events else 0
    if first_removed == 0 and first_state:
        probe = VariableSHGaussianModel(3, device=dev).load_numpy(
            {k: v.cpu().numpy() for k, v in first_state.items()})
        fires = {}
        with torch.no_grad():
            for box in MERCY_FIRE_BOXES:
                fires[box] = int(pruning_trainer.mercy_gaussians(probe, dataset,
                                                                 box_size=box).sum())
            _, counts, threshold, _, _ = mercy_decisions(probe, dataset, 1.0)
        log(f"phase 9: the first mercy event removed nothing at box 1: redundancy counts max "
            f"{int(counts.max())}, mean {float(counts.mean()):.4f}, threshold {threshold:.4f} "
            f"(no count exceeds it); removals on that model by box size {fires}")
        del probe
    log(f"phase 9 [{card}]: training() {FLAGSHIP_STEPS} steps of the flagship in {wall:.2f} s; "
        f"N {N_GAUSSIANS} -> {model.num_points}; median ordinary step {ordinary:.4f} ms; "
        f"losses {values}; launches {launches}")
    expected = {"composite_fwd": FLAGSHIP_STEPS, "composite_bwd": FLAGSHIP_STEPS,
                "composite_fwd_stats": len(dataset) * (len(F_IMPORTANCE) + 2 * len(F_CULL))}
    if launches != expected:
        failures.append(f"flagship launched {launches}, expected {expected}")
    if len(values) != FLAGSHIP_STEPS or not all(map(math.isfinite, values)):
        failures.append(f"flagship losses are not all finite: {values}")
    rows = {v.shape[0] for t in trainer.engine.state_trees().values() for v in t.values()}
    if rows != {model.num_points}:
        failures.append(f"per-Gaussian tensors have rows {sorted(rows)}")
    if failures:
        raise AssertionError("phase 9: " + "; ".join(failures))
    return launches, ordinary


def argmin_margin(x, centers):
    """[N] gap between each row's two nearest centres (ops.kmeans'
    distances, in assign's chunks) relative to the larger of the second
    distance and |x|^2 + |c|^2 of the nearest centre: the expansion
    |x|^2 - 2 x.c + |c|^2 rounds at about float32's epsilon times the
    latter, so a gap below it is the last bits', whatever the distances."""
    from reduced_3dgs_torch.ops.kmeans import ASSIGN_CHUNK, pairwise_sq_dists
    c2 = torch.sum(centers * centers, dim=1)
    gaps = []
    for xs in x.split(ASSIGN_CHUNK):
        top2 = torch.topk(pairwise_sq_dists(xs, centers), 2, dim=1, largest=False)
        d = top2.values
        scale = torch.maximum(d[:, 1], torch.sum(xs * xs, dim=1) + c2[top2.indices[:, 0]])
        gaps.append((d[:, 1] - d[:, 0]) / torch.clamp(scale, min=1e-30))
    return torch.cat(gaps)


def kmeans_phase(card, params):
    """Phase 10 (a): kmeans of each attribute of the bench scene on the card
    and on the CPU, KMEANS_ITERATIONS Lloyd iterations of KMEANS_CLUSTERS
    centres (the port's k-means++ on the card) in lockstep: each iteration
    assigns on both devices from the card's centres, equal on every row
    with a margin (argmin_margin), and the card's update must lie within
    TOL_KMEANS_CENTERS of the plain mean of its assignment on the CPU.
    Free-running, two runs
    drift apart, the card against itself too: float atomics move a centre
    by a last bit, a near-tie row flips, its centre moves by ~1e-4 and more
    rows follow. Also times kmeans on the card, tol 0 and KMEANS_ITERATIONS
    iterations, and runs it twice to show that drift."""
    from reduced_3dgs_torch.ops.kmeans import assign, kmeans, kmeanspp_init, lloyd
    from reduced_3dgs_torch.quantization import ExcludeZeroSHQuantizer
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    dev = torch.device("cuda")
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    quantizer = ExcludeZeroSHQuantizer()
    failures = []
    for key in quantizer.keys(model):
        x = quantizer.values(model, key).contiguous()
        x_cpu = x.cpu()
        weights = torch.ones((x.shape[0],), device=dev)
        centers = kmeanspp_init(x, weights, KMEANS_CLUSTERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        free, free_ids = kmeans(x, KMEANS_CLUSTERS, init_centers=centers,
                                max_iter=KMEANS_ITERATIONS, tol=0.0)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        again, again_ids = kmeans(x, KMEANS_CLUSTERS, init_centers=centers,
                                  max_iter=KMEANS_ITERATIONS, tol=0.0)
        on_margin = differ = 0
        center_err, margin_share = 0.0, []
        for _ in range(KMEANS_ITERATIONS):
            c_cpu = centers.cpu()
            ids_card, ids_cpu = assign(x, centers).cpu(), assign(x_cpu, c_cpu)
            margin = (argmin_margin(x, centers) > DECISION_MARGIN).cpu()
            margin_share.append(float(margin.float().mean()))
            differ += int((ids_card != ids_cpu).sum())
            on_margin += int(((ids_card != ids_cpu) & margin).sum())
            # The update on the card against its plain version on the CPU
            # (the mean of each cluster's rows, an empty cluster kept) from
            # the card's own assignment.
            new = lloyd(x, weights, centers, 1, 0.0)[0]
            counts = torch.bincount(ids_card, minlength=KMEANS_CLUSTERS).to(x.dtype)[:, None]
            sums = torch.zeros_like(c_cpu).index_add_(0, ids_card, x_cpu)
            plain = torch.where(counts > 0, sums / counts, c_cpu)
            center_err = max(center_err, float((new.cpu() - plain).abs().max()))
            centers = new
        log(f"phase 10 [{card}]: kmeans of {key} [{x.shape[0]}, {x.shape[1]}], "
            f"{KMEANS_CLUSTERS} clusters, {KMEANS_ITERATIONS} iterations: card {card_ms:.4f} ms "
            f"(tol 0); in lockstep with the CPU, rows with a margin {min(margin_share):.6f} "
            f"(least over the iterations), ids differ on {differ} row-iterations, {on_margin} "
            f"of them with a margin, updated centres within {center_err:.3e}; free-running "
            f"twice on the card: ids differ on {int((free_ids != again_ids).sum())} rows, "
            f"centres by {float((free - again).abs().max()):.3e}")
        if on_margin or not center_err <= TOL_KMEANS_CENTERS:
            failures.append(f"{key}: {on_margin} ids differ on rows with a margin, centres "
                            f"{center_err:.3e} apart")
    if failures:
        raise AssertionError("phase 10 kmeans: " + "; ".join(failures))


def quantize_phase(card, params, params_p):
    """Phase 10 (b): ExcludeZeroSHQuantizer.quantize at the bench scene,
    cold (no codebook, max_iter 300) on the perturbed start and warm
    (warm_max_iter 15) on the bench scene from that codebook, each timed by
    attribute with its Lloyd iterations; a warm event under the profiler."""
    from reduced_3dgs_torch.ops import kmeans as kmeans_module
    from reduced_3dgs_torch.quantization import ExcludeZeroSHQuantizer
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    dev = torch.device("cuda")
    start = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    target = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    quantizer = ExcludeZeroSHQuantizer()
    lloyd = kmeans_module.lloyd
    iterations = []

    def counted(*args):
        out = lloyd(*args)
        iterations.append(out[2])
        return out

    def event(model, codebook):
        times, codebooks = {}, {}
        kmeans_module.lloyd = counted
        try:
            for key in quantizer.keys(model):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                codebooks[key], _ = quantizer.produce_clusters_of(model, key, codebook.get(key))
                torch.cuda.synchronize()
                times[key] = (time.perf_counter() - t0) * 1e3
        finally:
            kmeans_module.lloyd = lloyd
        return times, codebooks

    quantizer.produce_clusters_of(start, "opacity")      # first-use costs
    iterations.clear()
    cold_ms, cold = event(start, {})
    cold_iters = list(iterations)
    iterations.clear()
    warm_ms, _ = event(target, cold)
    warm_iters = list(iterations)
    for name, ms, iters in (("cold", cold_ms, cold_iters), ("warm", warm_ms, warm_iters)):
        log(f"phase 10 [{card}]: quantize {name} at N={N_GAUSSIANS}: total "
            f"{sum(ms.values()):.4f} ms; by attribute (ms, Lloyd iterations) "
            + ", ".join(f"{k} {v:.4f} ({i})" for (k, v), i in zip(ms.items(), iters)))

    def warm_event():
        quantizer._codebook_dict = dict(cold)
        quantizer.quantize(target)

    stats = device_busy(warm_event, calls=3)
    n_launch, busy_ms, wall_ms, top, _ = stats
    if busy_ms > 0:
        log(f"phase 10 [{card}]: under torch.profiler, per warm quantize event: {n_launch:.0f} "
            f"device kernels and copies, device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
            f"(idle share {1 - busy_ms / wall_ms:.3f}); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
    else:
        log("phase 10: the warm quantize event's idle share not measured (the profiler saw no "
            "device time)")
    if max(warm_iters) > quantizer.warm_max_iter or max(cold_iters) > quantizer.max_iter:
        raise AssertionError(f"phase 10: Lloyd iterations cold {cold_iters}, warm {warm_iters}")


def quantize_cli_phase(card, params_p, src, wrappers, tmp, dense_config):
    """Phase 10 (c, d): train.main with --mode densify-pruning-shculling
    --quantize --with_scale_reg for FLAGSHIP_STEPS steps (phase 9's views,
    depths, start and schedule as -o options, quantize events at the start
    of steps 11 and 21), then quantize.main on its PLY, render.main
    --load_quantized and render.main of the dequantized PLY (and, for its
    PSNR, of the trained PLY), with the launch counts read around each."""
    from reduced_3dgs_torch import quantize, render, train
    from reduced_3dgs_torch.quantization import ExcludeZeroSHQuantizer, VectorQuantizer
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.trainer import AbstractTrainer
    dev = torch.device("cuda")
    start_ply = os.path.join(tmp, "start", "point_cloud.ply")
    VariableSHGaussianModel(3, device=dev).load_numpy(params_p).save_ply(start_ply)
    config = dict(FLAGSHIP_CONFIG, **{k: dense_config[k] for k in (
        "densify_grad_threshold", "densify_percent_dense", "prune_percent_too_big")},
                  **QUANTIZE_CLI_CONFIG)
    out = os.path.join(tmp, "quantized_flagship")
    argv = ["-s", src, "-d", out, "-i", str(FLAGSHIP_STEPS), "-l", start_ply,
            "--mode", "densify-pruning-shculling", "--quantize", "--with_scale_reg"]
    for k, v in config.items():
        argv += ["-o", f"{k}={v!r}"]

    step, quantize_fn = AbstractTrainer.step, VectorQuantizer.quantize
    step_times, events = {}, []

    def timed_step(self, camera):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = step(self, camera)
        end.record()
        step_times[self.curr_step] = (start, end)
        return result

    def timed_quantize(self, model, update_codebook=True):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = quantize_fn(self, model, update_codebook)
        end.record()
        events.append((update_codebook, model.num_points, start, end))
        return result

    AbstractTrainer.step, VectorQuantizer.quantize = timed_step, timed_quantize
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        losses = train.main(argv)
        torch.cuda.synchronize()
    finally:
        AbstractTrainer.step, VectorQuantizer.quantize = step, quantize_fn
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    values = torch.stack(losses).cpu().tolist()
    ms = {s: a.elapsed_time(b) for s, (a, b) in step_times.items()}
    event_steps = sorted(set(F_SPLIT + F_PRUNE + F_IMPORTANCE + F_CULL + F_RESET))
    ordinary = statistics.median(t for s, t in ms.items()
                                 if s not in event_steps and s not in Q_STEPS)
    updates = [(n, a.elapsed_time(b)) for u, n, a, b in events if u]
    log(f"phase 10 [{card}]: train.main --mode densify-pruning-shculling --quantize "
        f"--with_scale_reg, {FLAGSHIP_STEPS} steps in {wall:.2f} s; median ordinary step "
        f"{ordinary:.4f} ms; quantize event steps "
        + ", ".join(f"{s} {ms[s]:.4f} ms ({ms[s] / ordinary:.2f}x)" for s in Q_STEPS)
        + "; quantize events (N, ms) " + ", ".join(f"({n}, {t:.4f})" for n, t in updates)
        + "; other event steps " + ", ".join(f"{s} {ms[s] / ordinary:.2f}x" for s in event_steps)
        + f"; losses {values}; launches {launches}")
    failures = []
    expected = {"composite_fwd": FLAGSHIP_STEPS, "composite_bwd": FLAGSHIP_STEPS,
                "composite_fwd_stats": N_VIEWS * (len(F_IMPORTANCE) + 2 * len(F_CULL))}
    if launches != expected:
        failures.append(f"train.main launched {launches}, expected {expected}")
    if len(updates) != len(Q_STEPS) or len(events) != len(Q_STEPS) + 1:
        failures.append(f"quantize events {[(u, n) for u, n, _, _ in events]}")
    if len(values) != FLAGSHIP_STEPS or not all(map(math.isfinite, values)):
        failures.append(f"losses are not all finite: {values}")

    # (d) the offline quantizer and the two render paths of its output.
    it_dir = os.path.join(out, "point_cloud", f"iteration_{FLAGSHIP_STEPS}")
    out_q = os.path.join(tmp, "quantized_offline")
    t0 = time.perf_counter()
    quantize.main(["-s", out, "-d", out_q, "-i", str(FLAGSHIP_STEPS)])
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    q_dir = os.path.join(out_q, "point_cloud", f"iteration_{FLAGSHIP_STEPS}")
    raw_bytes = os.path.getsize(os.path.join(it_dir, "point_cloud.ply"))
    q_bytes = os.path.getsize(os.path.join(q_dir, "point_cloud_quantized.ply"))
    train_q_bytes = os.path.getsize(os.path.join(it_dir, "point_cloud_quantized.ply"))
    metrics, render_launches = {}, {}
    for name, model_dir, flags in (("quantized", out_q, ["--load_quantized"]),
                                   ("dequantized", out_q, []), ("raw", out, [])):
        for fn in wrappers.values():
            fn.launches = 0
        render.main(["-s", src, "-d", model_dir, "-i", str(FLAGSHIP_STEPS), *flags])
        torch.cuda.synchronize()
        render_launches[name] = {n: fn.launches for n, fn in wrappers.items()}
        with open(os.path.join(model_dir, "metrics.json")) as f:
            metrics[name] = json.load(f)
    loaded = ExcludeZeroSHQuantizer().load_quantized(
        VariableSHGaussianModel(3, device=dev), os.path.join(q_dir, "point_cloud_quantized.ply"))
    from_ply = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(q_dir, "point_cloud.ply"))
    with torch.no_grad():
        render_err = max(float((loaded(cam)["render"] - from_ply(cam)["render"]).abs().max())
                         for cam in render.prepare_dataset(src))
    psnr = {k: [m["psnr"] for m in v["per_image"]] for k, v in metrics.items()}
    log(f"phase 10 [{card}]: quantize.main of {loaded.num_points} Gaussians in {q_wall:.2f} s; "
        f"quantized PLY {q_bytes} B against the raw {raw_bytes} B (ratio "
        f"{q_bytes / raw_bytes:.6f}; the training's own quantized PLY {train_q_bytes} B); "
        f"render.main --load_quantized psnr {psnr['quantized']}, of the dequantized PLY "
        f"{psnr['dequantized']}, of the trained (raw) PLY {psnr['raw']}; max |render "
        f"difference| {render_err:.3e}; launches {render_launches}")
    for name, got in render_launches.items():
        if got != {"composite_fwd": N_VIEWS, "composite_fwd_stats": 0, "composite_bwd": 0}:
            failures.append(f"render {name} launched {got}")
    if (render_err > TOL_QUANTIZED_RENDER
            or metrics["quantized"]["per_image"] != metrics["dequantized"]["per_image"]):
        failures.append(f"the two renders of the quantized model differ by {render_err}")
    if not q_bytes / raw_bytes <= MAX_QUANTIZED_SIZE_RATIO:
        failures.append(f"quantized/raw size ratio {q_bytes / raw_bytes}")
    if loaded.num_points != from_ply.num_points or not bool((loaded._degrees == 3).all()):
        failures.append("the quantized model did not load with N rows at degree 3")
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))


def checkpoint_phase(card, params_p, src, tmp):
    """Phase 10 (e): save_checkpoint after CKPT_STEPS steps of a Trainer at
    the bench scene, load_checkpoint into a fresh trainer over other
    parameters, then CKPT_MORE_STEPS more steps on both: losses within
    TOL_CKPT_LOSS_REL, parameters within the JAX package's gradient bars
    (rtol TOL_CKPT_RTOL, atol TOL_CKPT_ATOL): B3's float atomics vary in
    their last bits between runs."""
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.trainer import Trainer
    from reduced_3dgs_torch.trainer.checkpoint import load_checkpoint, save_checkpoint
    dev = torch.device("cuda")
    dataset = prepare_dataset(src)
    order = [i % len(dataset) for i in range(CKPT_STEPS + CKPT_MORE_STEPS)]
    a = Trainer(VariableSHGaussianModel(3, device=dev).load_numpy(params_p), dataset,
                sh_degree_up_interval=4)
    for i in order[:CKPT_STEPS]:
        a.step(dataset[i])
    path = os.path.join(tmp, "checkpoint", "state.npz")
    t0 = time.perf_counter()
    save_checkpoint(a, path)
    save_s = time.perf_counter() - t0
    other = {k: v * np.float32(0.5) for k, v in params_p.items()}
    b = Trainer(VariableSHGaussianModel(3, device=dev).load_numpy(other), dataset,
                sh_degree_up_interval=4)
    t0 = time.perf_counter()
    load_checkpoint(b, path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    losses = {"a": [], "b": []}
    for i in order[CKPT_STEPS:]:
        losses["a"].append(a.step(dataset[i])[0])
        losses["b"].append(b.step(dataset[i])[0])
    la, lb = (torch.stack(v).cpu().double() for v in losses.values())
    loss_rel = float(((la - lb).abs() / la.abs()).max())
    worst, failures = {}, []
    for name, pa in a.model.param_dict().items():
        pa, pb = pa.detach().double(), b.model.param_dict()[name].detach().double()
        excess = (pa - pb).abs() - (TOL_CKPT_ATOL + TOL_CKPT_RTOL * pa.abs())
        worst[name] = float((pa - pb).abs().max())
        if bool((excess > 0).any()):
            failures.append(f"{name}: {int((excess > 0).sum())} entries outside the bars")
    log(f"phase 10 [{card}]: checkpoint of a Trainer after {CKPT_STEPS} steps at "
        f"N={a.model.num_points} ({os.path.getsize(path)} B) saved in {save_s:.3f} s, loaded in "
        f"{load_s:.3f} s; {CKPT_MORE_STEPS} more steps on both: losses {la.tolist()} and "
        f"{lb.tolist()}, max relative difference {loss_rel:.3e}; max |parameter difference| "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    if not loss_rel <= TOL_CKPT_LOSS_REL:
        failures.append(f"losses differ by {loss_rel:.3e} (relative)")
    if failures:
        raise AssertionError("phase 10 checkpoint: " + "; ".join(failures))


def camera_gradient(trainer, camera):
    """One step of a camera trainer on `camera`; the camera gradient it
    consumed (rot and trans, as float64 on the CPU)."""
    grads = []
    adjust = trainer.camera_adjustment

    def capturing(cam):
        params, apply, consume = adjust(cam)

        def keep(g):
            grads.append({k: v.detach().double().cpu() for k, v in g.items()})
            return consume(g)

        return params, apply, keep

    trainer.camera_adjustment = capturing
    try:
        trainer.step(camera)
    finally:
        del trainer.camera_adjustment
    (g,) = grads
    return g


def camera_phase(card, params_p, src, wrappers, tmp, dense_config, flagship_ms):
    """Phase 11: (a) train.main --mode camera-densify-pruning-shculling for
    FLAGSHIP_STEPS steps (phase 9's views, depths, start and schedule as -o
    options), with the launch counts, N, the step times and each view's
    learned pose (and, at the end, one more step's idle share under
    torch.profiler); (b) one step's
    camera gradient on the card against the CPU, on one view and the
    MERCY_SUBSET Gaussians of smallest x, from view 0's learned delta and
    Adam state; (c) render.main --load_camera of the run's cameras.json and
    PLY, and its cameras' renders against the trainer's adjusted cameras';
    (d) render_packed of the trained SH-culled model against its dense
    render; (e) mark_visible's count per view against the CPU's. Returns
    the launch counts of (a)."""
    from reduced_3dgs_torch import render, train
    from reduced_3dgs_torch.models.packed_sh import pack_variable_sh, render_packed
    from reduced_3dgs_torch.ops.rasterize.common import mark_visible
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.trainer import AbstractTrainer, CameraTrainerWrapper, Trainer
    from reduced_3dgs_torch.utils.math import psnr
    dev = torch.device("cuda")
    failures = []

    # (a) the camera flagship through its entry point.
    start_ply = os.path.join(tmp, "camera_start", "point_cloud.ply")
    VariableSHGaussianModel(3, device=dev).load_numpy(params_p).save_ply(start_ply)
    config = dict(FLAGSHIP_CONFIG, **{k: dense_config[k] for k in (
        "densify_grad_threshold", "densify_percent_dense", "prune_percent_too_big")})
    out = os.path.join(tmp, "camera_flagship")
    argv = ["-s", src, "-d", out, "-i", str(FLAGSHIP_STEPS), "-l", start_ply,
            "--mode", CAMERA_MODE]
    for k, v in config.items():
        argv += ["-o", f"{k}={v!r}"]
    runs, step_times = [], {}
    training, step = train.training, AbstractTrainer.step

    def keep(**kwargs):
        runs.append(kwargs)
        return training(**kwargs)

    def timed_step(self, camera):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = step(self, camera)
        end.record()
        step_times[self.curr_step] = (start, end)
        return result

    train.training, AbstractTrainer.step = keep, timed_step
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        losses = train.main(argv)
        torch.cuda.synchronize()
    finally:
        train.training, AbstractTrainer.step = training, step
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    (run,) = runs
    trainer, dataset, model = run["trainer"], run["dataset"], run["gaussians"]
    values = torch.stack(losses).cpu().tolist()
    ms = {s: a.elapsed_time(b) for s, (a, b) in step_times.items()}
    event_steps = sorted(set(F_SPLIT + F_PRUNE + F_IMPORTANCE + F_CULL + F_RESET))
    ordinary = statistics.median(t for s, t in ms.items() if s not in event_steps)
    poses = []
    for cam in dataset:
        p = trainer._cam_params[id(cam)]
        q = p["rot"].detach().double().cpu()
        angle = 2.0 * math.acos(min(1.0, abs(float(q[0])) / float(q.norm())))
        poses.append((float(p["trans"].detach().double().norm()), angle))
    log(f"phase 11 [{card}]: train.main --mode {CAMERA_MODE}, {FLAGSHIP_STEPS} steps in "
        f"{wall:.2f} s; {type(trainer).__name__} over {type(trainer.base_trainer).__name__}, "
        f"{type(dataset).__name__}, {type(model).__name__}; N {N_GAUSSIANS} -> "
        f"{model.num_points}; median ordinary step {ordinary:.4f} ms against the flagship's "
        f"{flagship_ms:.4f} ms (phase 9, same call); event steps "
        + ", ".join(f"{s} {ms[s] / ordinary:.2f}x" for s in event_steps)
        + f"; losses {values}; launches {launches}; learned pose per view (|trans|, rotation "
        f"angle in rad) {poses}")
    expected = {"composite_fwd": FLAGSHIP_STEPS, "composite_bwd": FLAGSHIP_STEPS,
                "composite_fwd_stats": N_VIEWS * (len(F_IMPORTANCE) + 2 * len(F_CULL))}
    # A camera step steps two optimizer states: the Gaussians' and its view's.
    expected = preprocess_expected(expected, adam=2 * FLAGSHIP_STEPS)
    if launches != expected:
        failures.append(f"train.main --mode {CAMERA_MODE} launched {launches}, expected "
                        f"{expected}")
    if len(values) != FLAGSHIP_STEPS or not all(map(math.isfinite, values)):
        failures.append(f"losses are not all finite: {values}")
    if len(poses) != N_VIEWS or not all(math.isfinite(t) and math.isfinite(a) and t > 0 and a > 0
                                        for t, a in poses):
        failures.append(f"learned poses {poses}")
    # The poses the run saved; (c) reads them back.
    adjusted = [trainer.adjusted_camera(cam) for cam in dataset]

    # (b) the camera gradient on the card against the CPU.
    view = 0
    key = id(dataset[view])
    slot = ({view: {k: v.detach().cpu().numpy() for k, v in trainer._cam_params[key].items()}},
            {view: {"count": trainer._cam_adam[key].count,
                    "m": {k: v.cpu().numpy() for k, v in trainer._cam_adam[key].m.items()},
                    "v": {k: v.cpu().numpy() for k, v in trainer._cam_adam[key].v.items()}}})
    subset = np.argsort(params_p["xyz"][:, 0], kind="stable")[:MERCY_SUBSET]
    sub = {k: v[subset] for k, v in params_p.items()}
    grads = []
    for where in (dev, torch.device("cpu")):
        views = render.prepare_dataset(src, device=where)
        m = VariableSHGaussianModel(3, device=where).load_numpy(sub)
        t = CameraTrainerWrapper(Trainer, m, views).load_numpy(*slot)
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        grads.append(camera_gradient(t, views[view]))
        step_s = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in wrappers.items()}
        log(f"phase 11 [{card}]: camera gradient on {where} in {step_s:.2f} s, launches "
            f"{counts}")
        if where.type == "cuda" and counts != preprocess_expected(
                {"composite_fwd": 1, "composite_fwd_stats": 0, "composite_bwd": 1}, adam=2):
            failures.append("the card's camera step did not launch B1, B3 and the preprocess "
                            "kernels once each and the Adam kernel twice")
    gk, gc = (torch.cat([g["rot"], g["trans"]]) for g in grads)
    scale = float(gc.abs().max())
    excess = (gk - gc).abs() - (GCAM_ATOL * scale + GCAM_RTOL * gc.abs())
    log(f"phase 11 [{card}]: camera gradient (rot w x y z, trans x y z) of view {view} at "
        f"{MERCY_SUBSET} Gaussians: card {gk.tolist()}, CPU {gc.tolist()}; max |difference| "
        f"{float((gk - gc).abs().max()):.3e} (bars rtol {GCAM_RTOL}, atol {GCAM_ATOL} x "
        f"max|g| {scale:.3e})")
    if not scale > 0 or bool((excess > 0).any()):
        failures.append("the card's camera gradient disagrees with the CPU's")

    # (c) render.main --load_camera of the learned poses.
    it = str(FLAGSHIP_STEPS)
    cams_json = os.path.join(out, "cameras.json")
    for fn in wrappers.values():
        fn.launches = 0
    render.main(["-s", src, "-d", out, "-i", it, "--no_save_images", "--load_camera",
                 cams_json])
    torch.cuda.synchronize()
    render_launches = {n: fn.launches for n, fn in wrappers.items()}
    with open(os.path.join(out, "metrics.json")) as f:
        got = [m["psnr"] for m in json.load(f)["per_image"]]
    trained = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(out, "point_cloud", f"iteration_{it}", "point_cloud.ply"))
    loaded = render.prepare_dataset(src, load_camera=cams_json)
    want, start_psnr, err = [], [], 0.0
    with torch.no_grad():
        for cam, moved, back in zip(dataset, adjusted, loaded):
            img = trained(moved)["render"]
            err = max(err, float((trained(back)["render"] - img).abs().max()))
            want.append(float(psnr(img, cam.ground_truth_image).mean()))
            start_psnr.append(float(psnr(trained(cam)["render"], cam.ground_truth_image).mean()))
    log(f"phase 11 [{card}]: render.main --load_camera: psnr {got} (the trainer's adjusted "
        f"cameras {want}; the start poses {start_psnr}); max |render from the loaded cameras - "
        f"render from the adjusted ones| {err:.3e} (bar {TOL_COLOR}); launches {render_launches}")
    if render_launches != preprocess_expected({"composite_fwd": N_VIEWS,
                                               "composite_fwd_stats": 0, "composite_bwd": 0}):
        failures.append(f"render.main --load_camera launched {render_launches}")
    if not err <= TOL_COLOR or not all(abs(a - b) <= 1e-3 for a, b in zip(got, want)):
        failures.append(f"the loaded poses render {err} from the adjusted ones")

    # (d) the packed SH model against the dense render.
    with torch.no_grad():
        packed = pack_variable_sh({k: v.detach() for k, v in model.param_dict().items()},
                                  model._degrees)
        for fn in wrappers.values():
            fn.launches = 0
        packed_imgs = [render_packed(packed, cam)["render"] for cam in dataset]
        torch.cuda.synchronize()
        packed_launches = {n: fn.launches for n, fn in wrappers.items()}
        packed_err = max(float((p - model(cam)["render"]).abs().max())
                         for p, cam in zip(packed_imgs, dataset))
    rows = packed["features_rest_packed"].shape[0]
    log(f"phase 11 [{card}]: render_packed of the trained model (degrees 0-3 "
        f"{packed['group_counts']}): {rows} rest rows against {15 * model.num_points} dense "
        f"(ratio {rows / (15 * model.num_points):.6f}); max |packed - dense render| "
        f"{packed_err:.3e} (bar {TOL_COLOR}); launches {packed_launches}")
    if packed_launches != preprocess_expected({"composite_fwd": N_VIEWS,
                                               "composite_fwd_stats": 0, "composite_bwd": 0}):
        failures.append(f"render_packed launched {packed_launches}")
    if not packed_err <= TOL_COLOR or not rows < 15 * model.num_points:
        failures.append(f"the packed model renders {packed_err} from the dense one")

    # (e) mark_visible.
    xyz_cpu = model._xyz.detach().cpu()
    visible = [int(model.mark_visible(cam).sum()) for cam in dataset]
    visible_cpu = [int(mark_visible(xyz_cpu, cam.world_view_transform.cpu()).sum())
                   for cam in dataset]
    log(f"phase 11: mark_visible per view {visible} of {model.num_points} (CPU {visible_cpu})")
    if visible != visible_cpu or not all(0 < v <= model.num_points for v in visible):
        failures.append(f"mark_visible counts {visible}, CPU {visible_cpu}")

    # Last, as it trains on: one more camera flagship step under the profiler.
    n_launch, busy_ms, busy_wall_ms, top, _ = device_busy(lambda: trainer.step(dataset[0]))
    if busy_ms > 0:
        log(f"phase 11 [{card}]: one camera flagship step under torch.profiler: {n_launch:.0f} "
            f"device kernels and copies, device busy {busy_ms:.4f} ms of {busy_wall_ms:.4f} ms "
            f"wall (idle share {1 - busy_ms / busy_wall_ms:.4f}); top: "
            + "; ".join(f"{k} x{c} {t:.4f} ms" for k, c, t in top))
    else:
        log("phase 11: the camera step's idle share not measured (the profiler saw no device "
            "time)")
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))
    return launches


def twodgs_train_phase(card, params_p, src, wrappers, tmp, dense_config, flagship_ms):
    """Phase 12 (a): train.main --backend gsplat-2dgs in the flagship mode
    for FLAGSHIP_STEPS steps and in the camera flagship mode for
    TWODGS_CAMERA_STEPS, on phase 9's views, start and schedule: N around
    every event, the step times, peak memory, one step's idle share, view
    0's entry count beside the 3DGS renderer's, and the compositors'
    launches, which must all be 0."""
    from reduced_3dgs_torch import train
    from reduced_3dgs_torch.ops.rasterize import twodgs
    from reduced_3dgs_torch.ops.rasterize.tiled import render_tiled
    from reduced_3dgs_torch.shculling import (CameraTrainableVariableSHGsplat2DGSGaussianModel,
                                              VariableSHGaussianModel,
                                              VariableSHGsplat2DGSGaussianModel)
    from reduced_3dgs_torch.trainer import AbstractTrainer
    dev = torch.device("cuda")
    failures = []
    start_ply = os.path.join(tmp, "twodgs_start", "point_cloud.ply")
    start = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    start.save_ply(start_ply)
    cam0 = view_camera(view_poses()[0], dev)
    with torch.no_grad():
        k3 = render_tiled(*start.render_array_args(), start.render_settings(cam0))["num_rendered"]
        k2 = twodgs.render_tiled_2dgs(*start.render_array_args(),
                                      start.render_settings(cam0))["num_rendered"]
    log(f"phase 12 [{card}]: view 0 of the perturbed start: K {k2} surfel entries against "
        f"{k3} of the 3DGS renderer")
    del start
    config = dict(FLAGSHIP_CONFIG, **{k: dense_config[k] for k in (
        "densify_grad_threshold", "densify_percent_dense", "prune_percent_too_big")})
    training, step = train.training, AbstractTrainer.step
    results = {}
    for mode, steps in (("densify-pruning-shculling", FLAGSHIP_STEPS),
                        (CAMERA_MODE, TWODGS_CAMERA_STEPS)):
        out = os.path.join(tmp, f"twodgs_{mode}")
        argv = ["-s", src, "-d", out, "-i", str(steps), "-l", start_ply, "--mode", mode,
                "--backend", "gsplat-2dgs"]
        for k, v in config.items():
            argv += ["-o", f"{k}={v!r}"]
        runs, step_times, sizes = [], {}, {}

        def keep(**kwargs):
            runs.append(kwargs)
            return training(**kwargs)

        def timed_step(self, camera):
            s = self.curr_step + 1
            sizes[s] = [self.model.num_points]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            result = step(self, camera)
            b.record()
            step_times[s] = (a, b)
            sizes[s].append(self.model.num_points)
            return result

        train.training, AbstractTrainer.step = keep, timed_step
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            losses = train.main(argv)
            torch.cuda.synchronize()
        finally:
            train.training, AbstractTrainer.step = training, step
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        (run,) = runs
        trainer, dataset, model = run["trainer"], run["dataset"], run["gaussians"]
        values = torch.stack(losses).cpu().tolist()
        ms = {s: a.elapsed_time(b) for s, (a, b) in step_times.items()}
        events = [s for s in sorted(set(F_SPLIT + F_PRUNE + F_IMPORTANCE + F_CULL + F_RESET))
                  if s <= steps]
        ordinary = statistics.median(t for s, t in ms.items() if s not in events)
        log(f"phase 12 [{card}]: train.main --backend gsplat-2dgs --mode {mode}, {steps} steps "
            f"in {wall:.2f} s; {type(trainer).__name__}, {type(model).__name__}; N "
            f"{N_GAUSSIANS} -> {model.num_points}; median ordinary step {ordinary:.4f} ms "
            f"(the 3DGS flagship's {flagship_ms:.4f} ms, phase 9); peak memory "
            f"{peak / 2**30:.3f} GiB ({base_bytes / 2**30:.3f} GiB allocated before); losses "
            f"{values}; launches {launches}")
        for s in events:
            log(f"phase 12: {mode} step {s}: {ms[s]:.4f} ms ({ms[s] / ordinary:.2f}x the median "
                f"ordinary step), N {sizes[s][0]} -> {sizes[s][1]}")
        want_cls = (CameraTrainableVariableSHGsplat2DGSGaussianModel if mode == CAMERA_MODE
                    else VariableSHGsplat2DGSGaussianModel)
        if type(model) is not want_cls:
            failures.append(f"{mode}: model class {type(model).__name__}")
        if launches != {"composite_fwd": 0, "composite_fwd_stats": 0, "composite_bwd": 0}:
            failures.append(f"{mode}: the 2DGS path launched {launches}")
        if len(values) != steps or not all(map(math.isfinite, values)):
            failures.append(f"{mode}: losses are not all finite: {values}")
        rows = {v.shape[0] for t in trainer.engine.state_trees().values() for v in t.values()}
        if rows != {model.num_points}:
            failures.append(f"{mode}: per-Gaussian tensors have rows {sorted(rows)}")
        if mode == CAMERA_MODE:
            moved = [float(trainer._cam_params[id(c)]["trans"].detach().norm()) for c in dataset]
            log(f"phase 12: {mode}: learned |trans| per view {moved}")
            if not all(m > 0 for m in moved):
                failures.append(f"{mode}: a view's pose did not move")
        else:
            split_n = [sizes[s] for s in F_SPLIT]
            if not any(b > a for a, b in split_n):
                failures.append("the 2DGS flagship's splits added nothing")
            busy = device_busy(lambda: trainer.step(dataset[0]), calls=3)
            n_launch, busy_ms, wall_ms, top, _ = busy
            if busy_ms > 0:
                log(f"phase 12 [{card}]: one 2DGS flagship step at N={model.num_points} under "
                    f"torch.profiler: {n_launch:.0f} device kernels and copies, busy "
                    f"{busy_ms:.4f} ms of {wall_ms:.4f} ms wall (idle share "
                    f"{1 - busy_ms / wall_ms:.4f}); top: "
                    + "; ".join(f"{k} x{c} {t:.4f} ms" for k, c, t in top))
            else:
                log("phase 12: the 2DGS step's idle share not measured (the profiler saw no "
                    "device time)")
        results[mode] = dict(ordinary=ordinary, peak=peak, n=model.num_points)
        del runs, run, trainer, dataset, model
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 12 (a): " + "; ".join(failures))
    return results


def twodgs_near(pre, ent, tiles_x, height, width):
    """Where the 2DGS compositor decides on the last bit, from float64
    copies of its fields on their device: per sorted entry and per image
    pixel, whether any (entry, pixel) pair holds the low-pass choice (rho3d
    against rho2d), the alpha gate or clamp, the near cull, the latch test
    or the |s_z| guard within DECISION_MARGIN of flipping. The latch is
    tested on every gated pair (a superset of those the walk reaches)."""
    from reduced_3dgs_torch import config as rc
    gidx, tile = ent["s_gidx"], ent["s_tile"]
    f = {k: pre[k].detach().double()[gidx] for k in ("M", "md", "center2d", "opacity")}
    M, md, c2d, op = f["M"], f["md"], f["center2d"], f["opacity"][:, None]
    seg_start = ent["range_start"].long()[tile]
    m = DECISION_MARGIN
    entry_near = torch.zeros(tile.numel(), dtype=torch.bool, device=tile.device)
    pixel_near = torch.zeros((256, tiles_x * ((height + 15) // 16)), dtype=torch.bool,
                             device=tile.device)
    for p0 in range(0, 256, 64):
        p = torch.arange(p0, p0 + 64, device=tile.device)[None, :]
        px = ((tile % tiles_x) * 16)[:, None] + p % 16
        py = ((tile // tiles_x) * 16)[:, None] + p // 16
        k = px[..., None] * M[:, None, 2, :] - M[:, None, 0, :]
        ll = py[..., None] * M[:, None, 2, :] - M[:, None, 1, :]
        s = torch.linalg.cross(k, ll, dim=-1)
        sz = torch.where(s[..., 2].abs() < 1e-9, torch.full_like(s[..., 2], 1e-9), s[..., 2])
        u, v = s[..., 0] / sz, s[..., 1] / sz
        rho3, rho2 = u * u + v * v, ((px - c2d[:, 0:1]) ** 2 + (py - c2d[:, 1:2]) ** 2) / 0.5
        g_op = op * torch.exp(-0.5 * torch.minimum(rho3, rho2))
        depth = torch.where(rho3 <= rho2, md[:, None, 0] * u + md[:, None, 1] * v
                            + md[:, None, 2], md[:, None, 2].expand_as(u))
        alpha = torch.clamp(g_op, max=rc.ALPHA_MAX)
        gate = (alpha >= rc.ALPHA_EPS) & (depth > rc.NEAR_CULL_Z)
        abar = torch.where(gate, alpha, torch.zeros_like(alpha))
        log1ma = torch.log1p(-abar).T
        lex = torch.cumsum(log1ma, dim=1) - log1ma
        t_in = torch.exp(lex - lex[:, seg_start]).T
        seen = g_op >= 0.5 * rc.ALPHA_EPS
        near = (((g_op - rc.ALPHA_EPS).abs() <= m * rc.ALPHA_EPS)
                | ((g_op - rc.ALPHA_MAX).abs() <= m)
                | (seen & ((rho3 - rho2).abs() <= m * rho2))
                | (seen & ((depth - rc.NEAR_CULL_Z).abs() <= m * rc.NEAR_CULL_Z))
                | (seen & ((s[..., 2].abs() - 1e-9).abs() <= m * 1e-9))
                | (gate & ((t_in * (1 - abar) - rc.T_EPS).abs() <= m * rc.T_EPS)))
        entry_near |= near.any(dim=1)
        hits = torch.zeros((64, pixel_near.shape[1]), dtype=torch.int32, device=tile.device)
        hits.index_add_(1, tile, near.T.to(torch.int32))
        pixel_near[p0:p0 + 64] |= hits > 0
    tiles_y = (height + 15) // 16
    img = pixel_near.T.reshape(tiles_y, tiles_x, 16, 16).permute(0, 2, 1, 3).reshape(
        tiles_y * 16, tiles_x * 16)[:height, :width]
    return entry_near, img


def twodgs_compare_phase(card, params, params_p):
    """Phase 12 (b): one 2DGS render and backward of the MERCY_SUBSET
    Gaussians of smallest x at view 0, on the card and on the CPU: every
    output within the JAX package's bars, every parameter's gradient and
    mean2d_offset_ndc's within rtol 2e-3 / atol 3e-5 of max|g|, and a
    with_stats render's counts exact and scores within 1e-4, outside the
    pixels and Gaussians a last-bit decision touches. (c): a late tile of
    view 0 in the full 2DGS render of the bench scene against the render of
    only the Gaussians whose rectangle covers it, within 1e-5."""
    from reduced_3dgs_torch.ops.rasterize import twodgs
    from reduced_3dgs_torch.ops.rasterize.tiled import bin_and_sort
    from reduced_3dgs_torch.shculling import VariableSHGsplat2DGSGaussianModel
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    failures = []
    subset = np.argsort(params_p["xyz"][:, 0], kind="stable")[:MERCY_SUBSET]
    sub = {k: v[subset] for k, v in params_p.items()}
    gen = np.random.default_rng(12)
    cot = {k: gen.normal(size=shape).astype(np.float32) for k, shape in (
        ("render", (3, HEIGHT, WIDTH)), ("final_T", (HEIGHT, WIDTH)), ("depth", (HEIGHT, WIDTH)),
        ("normal", (3, HEIGHT, WIDTH)), ("distortion", (HEIGHT, WIDTH)))}
    res = []
    for where in (dev, cpu):
        m = VariableSHGsplat2DGSGaussianModel(3, device=where).load_numpy(sub)
        cam = view_camera(view_poses()[0], where)
        offset = torch.zeros((m.num_points, 2), device=where, requires_grad=True)
        t0 = time.perf_counter()
        out = m.render(cam, offset)
        loss = sum(torch.sum(out[k] * torch.from_numpy(c).to(where)) for k, c in cot.items())
        loss.backward()
        with torch.no_grad():
            stats = m(cam, with_stats=True)
        if where.type == "cuda":
            torch.cuda.synchronize()
        grads = {f"_{k}": v.grad for k, v in m.param_dict().items()}
        grads["mean2d_offset_ndc"] = offset.grad
        res.append(dict(out={k: out[k].detach().cpu() for k in TWODGS_OUTPUTS},
                               grads={k: g.cpu() for k, g in grads.items()},
                               stats={k: v.cpu() for k, v in stats.items()
                                      if k in ("gaussians_count", "opacity_important_score",
                                               "T_alpha_important_score",
                                               "transmittance_sum")},
                               k=out["num_rendered"], s=time.perf_counter() - t0))
        if where is dev:
            with torch.no_grad():
                settings = m.render_settings(cam)
                pre = twodgs.preprocess_2dgs(*m.render_array_args(), settings)
                tiles_x = (WIDTH + 15) // 16
                ent = bin_and_sort(pre["rect_min"], pre["rect_max"], pre["tiles_touched"],
                                   pre["depths"], tiles_x, (HEIGHT + 15) // 16)
                entry_near, pixel_near = twodgs_near(pre, ent, tiles_x, HEIGHT, WIDTH)
                row_near = torch.zeros(m.num_points, dtype=torch.int32, device=dev).index_add_(
                    0, ent["s_gidx"], entry_near.to(torch.int32)) > 0
            row_near, pixel_near = row_near.cpu(), pixel_near.cpu()
        del m, out, loss, stats, grads, offset
    card_res, cpu_res = res
    keep_px = ~pixel_near
    errs = {}
    for k in TWODGS_OUTPUTS:
        d = (card_res["out"][k] - cpu_res["out"][k]).abs()
        errs[k] = float(d[..., keep_px].max())
        if not errs[k] <= TWODGS_ATOL[k]:
            failures.append(f"(b) {k} differs by {errs[k]} (bar {TWODGS_ATOL[k]})")
    g_errs = {}
    for k, gc in cpu_res["grads"].items():
        gk = card_res["grads"][k]
        keep = ~row_near
        scale = float(gc.abs().max())
        excess = ((gk - gc).abs() - (GCAM_ATOL * scale + GCAM_RTOL * gc.abs()))[keep]
        g_errs[k] = float((gk - gc)[keep].abs().max()) / max(scale, 1e-30)
        if not scale > 0 or bool((excess > 0).any()):
            failures.append(f"(b) the gradient of {k} differs (max|g| {scale})")
    counts_equal = bool(torch.equal(card_res["stats"]["gaussians_count"][~row_near],
                                    cpu_res["stats"]["gaussians_count"][~row_near]))
    # Scores within rtol 1e-4 and atol 1e-4, the JAX package's bar for its
    # statistics kernel (a score sums up to thousands of pixels).
    s_errs, s_fail = {}, False
    for k in ("opacity_important_score", "T_alpha_important_score", "transmittance_sum"):
        a, b = card_res["stats"][k][~row_near], cpu_res["stats"][k][~row_near]
        s_errs[k] = float((a - b).abs().max())
        s_fail |= bool(((a - b).abs() > 1e-4 + 1e-4 * b.abs()).any())
    if not counts_equal or s_fail:
        failures.append(f"(b) statistics differ: counts equal {counts_equal}, scores {s_errs}")
    log(f"phase 12 [{card}]: 2DGS render + backward + statistics of {MERCY_SUBSET} Gaussians "
        f"(K {card_res['k']} card, {cpu_res['k']} CPU) at view 0: card {card_res['s']:.2f} s, "
        f"CPU {cpu_res['s']:.2f} s; pixels with a decision within {DECISION_MARGIN} of its "
        f"threshold {int(pixel_near.sum())} of {HEIGHT * WIDTH}, Gaussians "
        f"{int(row_near.sum())}; outside them max |card - CPU| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; gradients max |d| / max|g| "
        + ", ".join(f"{k} {v:.3e}" for k, v in g_errs.items())
        + f"; counts equal {counts_equal}, scores (bar rtol 1e-4, atol 1e-4) max |d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in s_errs.items()))
    if card_res["k"] != cpu_res["k"]:
        failures.append(f"(b) K {card_res['k']} on the card, {cpu_res['k']} on the CPU")
    del res, card_res, cpu_res
    torch.cuda.empty_cache()

    # (c) tile independence at full K.
    model = VariableSHGsplat2DGSGaussianModel(3, device=dev).load_numpy(params)
    cam = view_camera(view_poses()[0], dev)
    with torch.no_grad():
        settings = model.render_settings(cam)
        pre = twodgs.preprocess_2dgs(*model.render_array_args(), settings)
        tiles_x, tiles_y = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
        ent = bin_and_sort(pre["rect_min"], pre["rect_max"], pre["tiles_touched"],
                           pre["depths"], tiles_x, tiles_y)
        rs, re = ent["range_start"].long(), ent["range_end"].long()
        busy = torch.nonzero(re > rs)[:, 0]
        t = int(busy[(busy.numel() * 9) // 10])            # a late, non-empty tile
        tx, ty = t % tiles_x, t // tiles_x
        lo, hi = pre["rect_min"], pre["rect_max"]
        cover = ((pre["tiles_touched"] > 0) & (lo[:, 0] <= tx) & (tx < hi[:, 0])
                 & (lo[:, 1] <= ty) & (ty < hi[:, 1]))
        full = model(cam)
        part = VariableSHGsplat2DGSGaussianModel(3, device=dev).load_numpy(
            {k: v[cover.cpu().numpy()] for k, v in params.items()})(cam)
        ys, xs = slice(ty * 16, min(ty * 16 + 16, HEIGHT)), slice(tx * 16, min(tx * 16 + 16, WIDTH))
        tile_err = max(float((full[k][..., ys, xs] - part[k][..., ys, xs]).abs().max())
                       for k in TWODGS_OUTPUTS)
    log(f"phase 12 [{card}]: tile independence at full K {full['num_rendered']}: tile {t} "
        f"(row {ty}, column {tx}) after {int(rs[t])} entries of earlier tiles, "
        f"{int(re[t] - rs[t])} of its own from {int(cover.sum())} Gaussians; max |full - "
        f"covering-only| over its pixels {tile_err:.3e} (bar {TOL_TILE})")
    if not tile_err <= TOL_TILE or not int(rs[t]) > 0.5 * full["num_rendered"]:
        failures.append(f"(c) tile {t} differs by {tile_err}")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
    return full["num_rendered"]


def viewer_phase(card, params, wrappers):
    """Phase 12 (d): the port's viewer over the bench scene's 3DGS model,
    served by a ThreadingHTTPServer on 127.0.0.1 (an ephemeral port):
    VIEWER_REQUESTS orbit frames at VIEWER_HEIGHT x VIEWER_WIDTH and one
    with the scale and SH overrides. Each PNG decodes to the uint8 of the
    model's render from the orbit camera, the overrides are restored, and
    the forward compositor launches once per frame; the time per request,
    and the served frames' render and PNG encode, stamped inside
    ViewerApp.render_frame."""
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from PIL import Image
    from reduced_3dgs_torch import viewer
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    dev = torch.device("cuda")
    failures = []
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    app = viewer.ViewerApp(model, VIEWER_HEIGHT, VIEWER_WIDTH)
    server = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    views = [dict(yaw=0.15 * i - 0.5, pitch=0.1 * (i % 3) - 0.1) for i in range(VIEWER_REQUESTS)]
    views.append(dict(yaw=0.2, pitch=0.05, scale=0.7, sh=1))
    frames, request_ms, render_ms, encode_ms = [], [], [], []
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/render?yaw=0",
                               timeout=120).read()                       # warm-up
        for fn in wrappers.values():
            fn.launches = 0
        for q in views:
            query = "&".join(f"{k}={v}" for k, v in q.items())
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_address[1]}/render?{query}",
                    timeout=120) as resp:
                body, headers = resp.read(), dict(resp.headers)
            request_ms.append((time.perf_counter() - t0) * 1e3)
            render_ms.append(app.last_frame_ms["render"])
            encode_ms.append(app.last_frame_ms["encode"])
            frames.append((body, headers))
        launches = {name: fn.launches for name, fn in wrappers.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    restored = (model.scale_modifier, model.active_sh_degree) == (1.0, 3)
    mismatched = 0
    for q, (body, headers) in zip(views, frames):
        got = np.asarray(Image.open(io.BytesIO(body)))
        model.scale_modifier, model.active_sh_degree = q.get("scale", 1.0), q.get("sh", 3)
        with torch.no_grad():
            want = viewer.to_uint8(model(app.camera(q["yaw"], q["pitch"]))["render"])
        model.scale_modifier, model.active_sh_degree = 1.0, 3
        mismatched += int((got != want).any(axis=-1).sum())
        if got.shape != (VIEWER_HEIGHT, VIEWER_WIDTH, 3) or headers["Content-Type"] != "image/png":
            failures.append(f"frame {q}: shape {got.shape}, {headers['Content-Type']}")
    log(f"phase 12 [{card}]: viewer over HTTP, {len(views)} frames at {VIEWER_HEIGHT}x"
        f"{VIEWER_WIDTH} ({model.num_points} Gaussians): median {statistics.median(request_ms):.2f}"
        f" ms per request (range {min(request_ms):.2f}-{max(request_ms):.2f}), of which the "
        f"served frames' render (with its copy to the host) median "
        f"{statistics.median(render_ms):.2f} ms and PNG encode median "
        f"{statistics.median(encode_ms):.2f} ms (perf_counter stamps in render_frame); "
        f"pixels differing from the direct "
        f"render {mismatched}; overrides restored {restored}; launches {launches}")
    if mismatched or not restored:
        failures.append(f"(d) {mismatched} pixels differ, overrides restored {restored}")
    if launches != {"composite_fwd": len(views), "composite_fwd_stats": 0, "composite_bwd": 0}:
        failures.append(f"(d) the viewer launched {launches} for {len(views)} frames")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))


def lpips_phase(card, params_p, src, dst, tmp):
    """Phase 12 (e): LPIPS with seeded random weights (the exporter's .npz
    layout) on the card against the CPU, with TF32 off, on the perturbed
    model's render of view 0 against its image; the same distance with
    cuDNN's TF32 allowed (lpips._distance, which leaves the switch as it
    finds it) must miss the bar, so that the check can tell the two apart;
    render.main with R3DGS_LPIPS_WEIGHTS set reports a finite LPIPS per
    view."""
    import importlib
    from reduced_3dgs_torch import render
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    lp = importlib.import_module("reduced_3dgs_torch.metrics.lpips")
    rng = np.random.default_rng(13)
    weights, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(lp._ALEX):
        weights[f"conv{i}/w"] = rng.normal(0, 0.05, (out_ch, in_ch, k, k)).astype(np.float32)
        weights[f"conv{i}/b"] = rng.normal(0, 0.01, (out_ch,)).astype(np.float32)
        weights[f"lin{i}/w"] = rng.random(out_ch).astype(np.float32)
        in_ch = out_ch
    path = os.path.join(tmp, "lpips_alex.npz")
    np.savez(path, **weights)
    dataset = prepare_dataset(src)
    model = VariableSHGaussianModel(3, device=torch.device("cuda")).load_numpy(params_p)
    with torch.no_grad():
        img = torch.clamp(model(dataset[0])["render"], 0, 1)
    gt = dataset[0].ground_truth_image
    tf32 = torch.backends.cudnn.allow_tf32
    values = {}
    for name, where in (("cuda", torch.device("cuda")), ("cpu", torch.device("cpu"))):
        params = lp.load_lpips_params(weights, where)
        lp.lpips(img.to(where), gt.to(where), params)               # warm-up
        t0 = time.perf_counter()
        values[name] = float(lp.lpips(img.to(where), gt.to(where), params))
        values[f"{name}_s"] = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True
    try:
        values["cuda_tf32"] = float(lp._distance(lp.load_lpips_params(weights, img.device),
                                                 img, gt.to(img.device)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = abs(values["cuda"] - values["cpu"])
    err_tf32 = abs(values["cuda_tf32"] - values["cpu"])
    before = os.environ.get("R3DGS_LPIPS_WEIGHTS")
    os.environ["R3DGS_LPIPS_WEIGHTS"] = path
    try:
        render.main(["-s", src, "-d", dst, "-i", "1", "--no_save_images"])
    finally:
        if before is None:
            del os.environ["R3DGS_LPIPS_WEIGHTS"]
        else:
            os.environ["R3DGS_LPIPS_WEIGHTS"] = before
    with open(os.path.join(dst, "metrics.json")) as f:
        per_image = [m.get("lpips") for m in json.load(f)["per_image"]]
    log(f"phase 12 [{card}]: LPIPS (seeded weights) of the perturbed render of view 0 at "
        f"{HEIGHT}x{WIDTH}: card {values['cuda']!r} ({values['cuda_s']:.3f} s), CPU "
        f"{values['cpu']!r} ({values['cpu_s']:.3f} s), |difference| {err:.3e} (bar "
        f"{TOL_LPIPS}); with cuDNN's TF32 allowed {values['cuda_tf32']!r}, |difference| "
        f"{err_tf32:.3e}; TF32 switch restored {torch.backends.cudnn.allow_tf32 == tf32}; "
        f"render.main with the weights: lpips per view {per_image}")
    if not err <= TOL_LPIPS or torch.backends.cudnn.allow_tf32 != tf32:
        raise AssertionError(f"phase 12 (e): LPIPS on the card {err} from the CPU's")
    if not err_tf32 > TOL_LPIPS:
        raise AssertionError(f"phase 12 (e): with TF32 allowed the card is {err_tf32} from "
                             "the CPU, within the bar: the check cannot tell TF32 on from off")
    if len(per_image) != N_VIEWS or not all(v is not None and math.isfinite(v) and v > 0
                                            for v in per_image):
        raise AssertionError(f"phase 12 (e): render.main reported LPIPS {per_image}")


def native_io_phase(card, params, tmp):
    """Phase 12 (f): the bench scene's PLY written by the native library and
    by numpy, byte for byte equal, each read back, with the seconds of each
    path; the native path must have run."""
    from reduced_3dgs_torch.models import native_io, ply
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    model = VariableSHGaussianModel(3, device=torch.device("cuda")).load_numpy(params)
    t0 = time.perf_counter()
    active = native_io.active()
    build_s = time.perf_counter() - t0
    times, paths, data = {}, {}, {}
    get_lib = native_io.get_lib
    for way in ("native", "numpy"):
        path = os.path.join(tmp, f"ply_{way}.ply")
        if way == "numpy":
            native_io.get_lib = lambda: None
        try:
            t0 = time.perf_counter()
            model.save_ply(path)
            times[f"write_{way}"] = time.perf_counter() - t0
            paths[f"write_{way}"] = native_io.last_path("write_ply")
            t0 = time.perf_counter()
            back = ply.read_ply(path)
            times[f"read_{way}"] = time.perf_counter() - t0
            paths[f"read_{way}"] = native_io.last_path("read_ply")
        finally:
            native_io.get_lib = get_lib
        with open(path, "rb") as f:
            data[way] = f.read()
        if len(back["vertex"]) != N_GAUSSIANS:
            raise AssertionError(f"phase 12 (f): the {way} read gave {len(back['vertex'])} rows")
    log(f"phase 12 [{card}]: PLY of {N_GAUSSIANS} Gaussians ({len(data['native'])} bytes): "
        f"native library active {active} (built and loaded in {build_s:.2f} s, error "
        f"{native_io.build_error()}); " + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
        + f"; paths {paths}; bytes equal {data['native'] == data['numpy']}")
    if not active or paths != {"write_native": "native", "read_native": "native",
                               "write_numpy": "numpy", "read_numpy": "numpy"}:
        raise AssertionError(f"phase 12 (f): the native path did not run: {paths}")
    if data["native"] != data["numpy"]:
        raise AssertionError("phase 12 (f): native and numpy PLY bytes differ")


def profiling_phase(card, params_p, src, tmp):
    """Phase 12 (g): utils.profiling.trace around one training step writes a
    Chrome trace, and time_fn times a render."""
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.trainer import Trainer
    from reduced_3dgs_torch.utils import profiling
    dataset = prepare_dataset(src)
    model = VariableSHGaussianModel(3, device=torch.device("cuda")).load_numpy(params_p)
    trainer = Trainer(model, dataset)
    trainer.step(dataset[0])
    log_dir = os.path.join(tmp, "trace")
    with profiling.trace(log_dir):
        with profiling.annotate("r3dgs_step"):
            trainer.step(dataset[1])
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    on_card = sum(1 for e in events if e.get("cat") == "kernel")
    annotated = any(e.get("name") == "r3dgs_step" for e in events)
    with torch.no_grad():
        timed = profiling.time_fn(model, dataset[0], iters=5)
    log(f"phase 12 [{card}]: profiling.trace of one step wrote {len(files)} file(s), "
        f"{os.path.getsize(files[0])} bytes, {len(events)} events ({on_card} device kernels, "
        f"annotation found {annotated}); time_fn of a render {timed}")
    if len(files) != 1 or not annotated or not (math.isfinite(timed["mean_s"])
                                                and timed["mean_s"] > 0):
        raise AssertionError("phase 12 (g): the trace or time_fn failed")


def counted(wrappers, fn):
    """(fn(), the kernels' launches during it): every count set to 0
    just before and read just after, the card synchronised."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def with_preprocess(wrappers):
    """The compositors' ``wrappers``, the preprocess kernels', the binning
    kernels' and the Adam kernel's."""
    from reduced_3dgs_torch.ops.rasterize import binning_kernel as bk
    from reduced_3dgs_torch.ops.rasterize import preprocess_kernel as pk
    from reduced_3dgs_torch.trainer import optimizer
    return dict(wrappers, preprocess_fwd=pk.preprocess_fwd, preprocess_bwd=pk.preprocess_bwd,
                bin_count=bk.bin_count, bin_sort=bk.bin_sort, adam_fused=optimizer.adam_fused)


def preprocess_expected(expected, adam=0):
    """The compositors' ``expected`` launches with the preprocess and
    binning kernels' they imply, and ``adam`` of the Adam kernel (the Adam
    steps taken times the optimizer states a step steps): each render's
    preprocess launches the forward kernel once and its binning each binning
    kernel once before its compositor (B1 or B2), and each backward through
    B3 launches the backward kernel once."""
    renders = expected["composite_fwd"] + expected["composite_fwd_stats"]
    return dict(expected, preprocess_fwd=renders, preprocess_bwd=expected["composite_bwd"],
                bin_count=renders, bin_sort=renders, adam_fused=adam)


def band_phase(card, params, params_p, camera, loss_cam, gt, wrappers):
    """Phase 13 (a): the bench scene rendered as the bands of 2, 3 and 4
    tile ranks in turn, in one process, through render_band, against one
    full render: the stitched colour, T and depth, the bands' entry counts,
    their statistics and the gradient of the full image's loss through the
    spliced bands, with the compositors' launches; then the 2DGS model's
    bands."""
    from reduced_3dgs_torch.ops.ssim import ssim
    from reduced_3dgs_torch.parallel.sharding import band_layout
    from reduced_3dgs_torch.shculling import (VariableSHGaussianModel,
                                              VariableSHGsplat2DGSGaussianModel)
    from reduced_3dgs_torch.utils.math import l1_loss
    dev = torch.device("cuda")
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    model_p = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    failures = []

    def stitch(bands, key):
        dim = 1 if key == "render" else 0
        return torch.cat([b[key] for b in bands], dim=dim).narrow(dim, 0, HEIGHT)

    def gradients(render):
        """The loss gradient of every parameter and of the screen-space
        offset, for the image render(offset) of the perturbed model."""
        offset = torch.zeros((model_p.num_points, 2), device=dev, requires_grad=True)
        img = render(offset)
        loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
        leaves = dict(model_p.param_dict(), mean2d_offset=offset)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    with torch.no_grad():
        full = model(camera)
        full_stats = model(camera, with_stats=True)
    g_full = gradients(lambda off: model_p.render(loss_cam, off)["render"])
    for n_tile in BAND_TILES:
        rows = band_layout(HEIGHT, n_tile)[0]
        starts = [r * rows for r in range(n_tile)]
        with torch.no_grad():
            bands, launches = counted(
                wrappers, lambda: [model.render_band(camera, s, rows) for s in starts])
            stats, s_launches = counted(wrappers, lambda: [
                model.render_band(camera, s, rows, with_stats=True) for s in starts])
        err = {k: float((stitch(bands, k) - full[k]).abs().max())
               for k in ("render", "final_T", "depth")}
        k_bands = [b["num_rendered"] for b in bands]
        counts_equal = all(torch.equal(sum(s[k] for s in stats), full_stats[k])
                           for k in ("gaussians_count", "touched_pixels"))
        score_err = max(float((sum(s[k] for s in stats) - full_stats[k]).abs().max())
                        / float(full_stats[k].abs().max())
                        for k in ("opacity_important_score", "T_alpha_important_score",
                                  "transmittance_sum"))
        g_band, g_launches = counted(wrappers, lambda: gradients(lambda off: torch.cat(
            [model_p.render_band(loss_cam, s, rows, off)["render"] for s in starts],
            dim=1)[:, :HEIGHT]))
        g_worst = max(float(((g_band[k] - g).abs() - BAND_GRAD_RTOL * g.abs()).max())
                      / float(g.abs().max()) for k, g in g_full.items())
        log(f"phase 13 [{card}]: {n_tile} bands of {rows} tile rows (padded height "
            f"{rows * 16 * n_tile}): max |stitched - full| colour {err['render']:.3e}, T "
            f"{err['final_T']:.3e}, depth {err['depth']:.3e}; K per band {k_bands}, sum "
            f"{sum(k_bands)} against {full['num_rendered']}; launches {launches}; statistics "
            f"counts equal {counts_equal}, scores' worst |diff| / max {score_err:.3e}, launches "
            f"{s_launches}; gradient through the spliced bands against the full render's: "
            f"worst (|diff| - {BAND_GRAD_RTOL} |g|) / max|g| {g_worst:.3e} (bar "
            f"{BAND_GRAD_ATOL}), launches {g_launches}")
        if max(err.values()) > TOL_BAND:
            failures.append(f"{n_tile} bands differ from the full render: {err}")
        if sum(k_bands) != full["num_rendered"]:
            failures.append(f"{n_tile} bands hold {sum(k_bands)} entries, the image "
                            f"{full['num_rendered']}")
        if launches != {"composite_fwd": n_tile, "composite_fwd_stats": 0, "composite_bwd": 0}:
            failures.append(f"{n_tile} band renders launched {launches}")
        if not counts_equal or score_err > TOL_STATS_REL:
            failures.append(f"{n_tile} bands' statistics: counts equal {counts_equal}, "
                            f"scores {score_err:.3e}")
        if s_launches != {"composite_fwd": 0, "composite_fwd_stats": n_tile, "composite_bwd": 0}:
            failures.append(f"{n_tile} band statistics renders launched {s_launches}")
        if not g_worst <= BAND_GRAD_ATOL:
            failures.append(f"{n_tile} bands' gradient {g_worst:.3e}")
        if g_launches != {"composite_fwd": n_tile, "composite_fwd_stats": 0,
                          "composite_bwd": n_tile}:
            failures.append(f"{n_tile} bands' gradient launched {g_launches}")
        del bands, stats, g_band
    del model_p, g_full, full_stats
    torch.cuda.empty_cache()

    model2 = VariableSHGsplat2DGSGaussianModel(3, device=dev).load_numpy(params)
    keys = ("render", "final_T", "depth")
    with torch.no_grad():
        full2, again = model2(camera), model2(camera)
        scale = {k: float(full2[k].abs().max()) for k in keys}
        noise = {k: float((again[k] - full2[k]).abs().max()) / scale[k] for k in keys}
        del again
        for n_tile in BAND_TILES:
            rows = band_layout(HEIGHT, n_tile)[0]
            bands, launches = counted(wrappers, lambda: [
                model2.render_band(camera, r * rows, rows) for r in range(n_tile)])
            err = {k: float((stitch(bands, k) - full2[k]).abs().max()) / scale[k] for k in keys}
            log(f"phase 13 [{card}]: 2DGS, {n_tile} bands: max |stitched - full| / max|full| "
                f"colour {err['render']:.3e}, T {err['final_T']:.3e}, depth {err['depth']:.3e} "
                f"(bar {TOL_TILE}; a second full render differs from the first by "
                f"{noise['render']:.3e}, {noise['final_T']:.3e}, {noise['depth']:.3e}); "
                f"launches {launches}")
            if max(err.values()) > TOL_TILE:
                failures.append(f"2DGS: {n_tile} bands differ from the full render: {err}")
            if any(launches.values()):
                failures.append(f"2DGS bands launched {launches}")
    if failures:
        raise AssertionError("phase 13 (a): " + "; ".join(failures))


def record_main(argv, wrappers):
    """train.main(argv) with, after every step, N and the step's time (CUDA
    events), and the compositors' launches over the training run: a dict
    with "n", "ms", "losses", "launches", "engine" (the engine's class),
    "mesh" and the final model's parameters and degrees on the host."""
    from reduced_3dgs_torch import train
    from reduced_3dgs_torch.trainer import AbstractTrainer
    rec = {"n": [], "ms": [], "events": []}
    training, step = train.training, AbstractTrainer.step

    def keep(**kwargs):
        rec["model"], rec["trainer"] = kwargs["gaussians"], kwargs["trainer"]
        for w in wrappers.values():
            w.launches = 0
        out = training(**kwargs)
        torch.cuda.synchronize()
        rec["launches"] = {name: w.launches for name, w in wrappers.items()}
        return out

    def timed_step(self, cameras):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(self, cameras)
        end.record()
        rec["events"].append((start, end))
        rec["n"].append(rec["model"].num_points)
        return out

    train.training, AbstractTrainer.step = keep, timed_step
    try:
        losses = train.main(argv)
    finally:
        train.training, AbstractTrainer.step = training, step
    model, engine = rec.pop("model"), rec.pop("trainer").engine
    rec["ms"] = [a.elapsed_time(b) for a, b in rec.pop("events")]
    mesh = getattr(engine, "mesh", None)
    return dict(rec, losses=torch.stack(losses).cpu().tolist(), engine=type(engine).__name__,
                mesh=None if mesh is None else dict(mesh.shape),
                degrees=model._degrees.cpu(),
                params={k: p.detach().cpu() for k, p in model.param_dict().items()})


def mesh_rank(result_path, argv):
    """One rank of phase 13 (c), started by mesh_phase with RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT:
    record_main(argv), saved to result_path."""
    from reduced_3dgs_torch.ops.rasterize import composite
    wrappers = {"composite_fwd": composite.composite_fwd,
                "composite_fwd_stats": composite.composite_fwd_stats,
                "composite_bwd": composite.composite_bwd}
    torch.save(record_main(argv, wrappers), result_path)
    return 0


def mesh_phase(card, params_p, src, wrappers, tmp, dense_config):
    """Phase 13 (b) and (c): train.main in the flagship mode for MESH_STEPS
    steps from phase 9's start (one densify event, one importance sweep), in
    this process, then with --mesh 1x1 for MESH_ONE_BY_ONE_STEPS steps
    (ShardedTrainer on a world of one: the same losses), then over two
    processes on this card with --mesh 1x2 and --mesh 2x1 (gloo): both
    ranks' parameters bitwise equal, N moving at the events, each rank's
    launches, and the step times."""
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    dev = torch.device("cuda")
    failures = []
    start_ply = os.path.join(tmp, "mesh_start", "point_cloud.ply")
    VariableSHGaussianModel(3, device=dev).load_numpy(params_p).save_ply(start_ply)
    config = dict(MESH_CONFIG, **{k: dense_config[k] for k in (
        "densify_grad_threshold", "densify_percent_dense", "prune_percent_too_big")})

    def argv(name, steps, mesh=None):
        args = ["-s", src, "-d", os.path.join(tmp, f"mesh_{name}"), "-i", str(steps),
                "-l", start_ply, "--save_iterations", str(steps)]
        for k, v in config.items():
            args += ["-o", f"{k}={v!r}"]
        return args + (["--mesh", mesh] if mesh else [])

    def ordinary_ms(run):
        return statistics.median(ms for s, ms in enumerate(run["ms"], 1)
                                 if s > 1 and s not in (M_SPLIT, M_IMPORTANCE))

    def n_moves(run):
        return [s for s in range(2, len(run["n"]) + 1) if run["n"][s - 1] != run["n"][s - 2]]

    t0 = time.perf_counter()
    single = record_main(argv("single", MESH_STEPS), wrappers)
    torch.cuda.empty_cache()
    one = record_main(argv("1x1", MESH_ONE_BY_ONE_STEPS, "1x1"), wrappers)
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(one["losses"], single["losses"]))
    log(f"phase 13 [{card}]: train.main flagship, {MESH_STEPS} steps in one process: N "
        f"{single['n'][0]} -> {single['n'][-1]}, N moves after steps {n_moves(single)}, median "
        f"ordinary step {ordinary_ms(single):.4f} ms, launches {single['launches']}; --mesh 1x1 "
        f"({one['engine']}, mesh {one['mesh']}) for {MESH_ONE_BY_ONE_STEPS} steps: worst "
        f"relative loss difference {rel:.3e} (bar {TOL_ONE_BY_ONE_REL}), launches "
        f"{one['launches']}; {time.perf_counter() - t0:.1f} s")
    if n_moves(single) != [M_SPLIT, M_IMPORTANCE]:
        failures.append(f"single process: N moved after steps {n_moves(single)}")
    if one["engine"] != "ShardedTrainer" or one["mesh"] != {"data": 1, "tile": 1}:
        failures.append(f"--mesh 1x1 trained with {one['engine']} on {one['mesh']}")
    if not rel <= TOL_ONE_BY_ONE_REL:
        failures.append(f"--mesh 1x1 losses differ from the single process's by {rel:.3e}")
    expected = {"composite_fwd": MESH_STEPS, "composite_bwd": MESH_STEPS,
                "composite_fwd_stats": N_VIEWS}
    if single["launches"] != expected:
        failures.append(f"single process launched {single['launches']}, expected {expected}")

    for mesh in MESHES:
        t0 = time.perf_counter()
        n_data, n_tile = (int(x) for x in mesh.split("x"))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        paths = [os.path.join(tmp, f"mesh_{mesh}_rank{r}.pt") for r in range(2)]
        procs = []
        try:
            for rank in range(2):
                # The host's cores shared between the two ranks.
                env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--mesh-rank", paths[rank],
                     *argv(mesh, MESH_STEPS, mesh)],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate(timeout=MESH_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"phase 13: --mesh {mesh} rank {rank} exited "
                                     f"{p.returncode}:\n{out[-3000:]}")
        runs = [torch.load(p, weights_only=False) for p in paths]
        equal = (all(torch.equal(runs[0]["params"][k], runs[1]["params"][k])
                     for k in runs[0]["params"])
                 and torch.equal(runs[0]["degrees"], runs[1]["degrees"])
                 and runs[0]["losses"] == runs[1]["losses"] and runs[0]["n"] == runs[1]["n"])
        run = runs[0]
        expected = {"composite_fwd": MESH_STEPS, "composite_bwd": MESH_STEPS,
                    "composite_fwd_stats": -(-N_VIEWS // n_data)}
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], single["losses"]))
        n_rel = max(abs(a - b) / b for a, b in zip(run["n"], single["n"]))
        log(f"phase 13 [{card}]: train.main --mesh {mesh}, two processes on one card over "
            f"gloo, {MESH_STEPS} steps in {time.perf_counter() - t0:.1f} s: engine "
            f"{run['engine']}, mesh {run['mesh']}; ranks' parameters, degrees, losses and N "
            f"bitwise equal {equal}; N {run['n'][0]} -> {run['n'][-1]}, moves after steps "
            f"{n_moves(run)}; N after each step against the single process's, worst relative "
            f"difference {n_rel:.3e}; losses against the single process's, worst relative "
            f"difference {loss_rel:.3e}; launches per rank {[r['launches'] for r in runs]}; "
            f"median ordinary step per rank {[round(ordinary_ms(r), 4) for r in runs]} ms "
            f"against the single process's {ordinary_ms(single):.4f} ms")
        if not equal:
            failures.append(f"--mesh {mesh}: the ranks' replicas differ")
        if run["engine"] != "ShardedTrainer" or run["mesh"] != {"data": n_data, "tile": n_tile}:
            failures.append(f"--mesh {mesh} trained with {run['engine']} on {run['mesh']}")
        if n_moves(run) != n_moves(single):
            failures.append(f"--mesh {mesh}: N moved after steps {n_moves(run)}")
        if any(r["launches"] != expected for r in runs):
            failures.append(f"--mesh {mesh} launched {[r['launches'] for r in runs]}, "
                            f"expected {expected} per rank")
        if not all(map(math.isfinite, run["losses"])):
            failures.append(f"--mesh {mesh}: losses {run['losses']}")
        if mesh == "1x2" and not (loss_rel <= MESH_LOSS_RTOL and n_rel <= MESH_N_REL):
            failures.append(f"--mesh 1x2 against the single process: losses {loss_rel:.3e}, "
                            f"N {n_rel:.3e}")
    if failures:
        raise AssertionError("phase 13 (b, c): " + "; ".join(failures))


def step_times(times, events, rows, iters):
    """(seconds of steps 2..iters by kind, median ms of the ordinary ones,
    their count) from the synchronised clock ``times[s]`` read after each
    step s. A step's time holds its event's work when it is an event step,
    and the evaluation and checkpoint after the step before it when that
    one is a history row."""
    busy = {s for steps in events.values() for s in steps}
    split = {"after a history row": 0.0, "event steps": 0.0, "ordinary": 0.0}
    ordinary = []
    for s in range(2, iters + 1):
        dt = times[s] - times[s - 1]
        kind = ("after a history row" if s - 1 in rows
                else "event steps" if s in busy else "ordinary")
        split[kind] += dt
        if kind == "ordinary":
            ordinary.append(dt * 1e3)
    return ({k: round(v, 3) for k, v in split.items()},
            statistics.median(ordinary) if ordinary else float("nan"), len(ordinary))


def convergence_phase(card, wrappers, tmp):
    """Phase 14: the convergence proof's run() at the full preset on the
    card, with the compositors' launches against the schedule's, N after
    every step against the event steps, the degrees around the SH cull, the
    four bars, the median ordinary step of both runs and, as a reading, the
    PSNR of the quantized PLY loaded back. Returns the launches."""
    from reduced_3dgs_torch.quantization import ExcludeZeroSHQuantizer
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.tools import convergence_proof as cp
    cfg = cp.PRESETS[CONVERGENCE_PRESET]
    iters, n_cams = cfg["iters"], cfg["cams"]
    watch = {"times": {"reduced": {}, "baseline": {}}, "events": {}, "n": {0: cfg["n_init"]},
             "degrees": {}}

    def on_step(tag, step, trainer):
        torch.cuda.synchronize()
        watch["times"][tag][step] = time.perf_counter()
        if tag not in watch["events"]:
            watch["events"][tag] = cp.event_steps(trainer, iters)
        if tag != "reduced":
            return
        model = trainer.model
        watch["n"][step] = model.num_points
        watch["sh_degree"] = model.active_sh_degree
        cull = watch["events"][tag]["SHCuller"]
        if step in cull or step + 1 in cull:
            watch["degrees"][step] = torch.bincount(model._degrees.long(), minlength=4).tolist()

    workdir = os.path.join(tmp, "convergence")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_regrows() as regrows:
        result, launches = counted(wrappers, lambda: cp.run(
            cfg, device="cuda", workdir=workdir, preset=CONVERGENCE_PRESET, on_step=on_step))
    t_end = time.perf_counter()
    wall = t_end - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 14 [{card}]: "
        + json.dumps({k: v for k, v in result.items() if k != "history"}))

    every = max(1, iters // 20)
    rows = [s for s in range(1, iters + 1) if s % every == 0 or s == iters]
    eval_views = len(range(0, n_cams, max(1, n_cams // 6)))
    events = watch["events"]["reduced"]
    # One statistics render per view and sweep pass: a pass more for each
    # key buffer regrown by a sweep.
    sweeps = len(events["ImportancePruner"]) + 2 * len(events["SHCuller"])
    passes = sweeps + regrows.count
    expected = preprocess_expected({
        "composite_fwd": 2 * iters + n_cams + (1 + len(rows) + 1) * eval_views,
        "composite_fwd_stats": n_cams * passes, "composite_bwd": 2 * iters}, adam=2 * iters)
    log(f"phase 14: event steps {json.dumps(events)}; baseline's "
        f"{json.dumps({k: (v[0], v[-1], len(v)) for k, v in watch['events']['baseline'].items() if v})} "
        f"(first, last, count); sweep passes {passes} for {sweeps} sweeps ({regrows.count} "
        f"key buffers regrown); launches "
        f"{launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"phase 14 launched {launches}, expected {expected}")

    n = watch["n"]
    moved = sorted(s for s in range(1, iters + 1) if n[s] != n[s - 1])
    movers = set(events["BasePruner"]) | set(events["SplitCloneDensifier"]) | set(
        events["ImportancePruner"])
    log(f"phase 14: N moved after {len(moved)} steps, all of them event steps: "
        f"{set(moved) <= movers}; N after each importance sweep "
        f"{[(s, n[s - 1], n[s]) for s in events['ImportancePruner']]}")
    if not moved or not set(moved) <= movers:
        raise AssertionError(f"N moved after steps {sorted(set(moved) - movers)} outside the "
                             "scheduled events")
    if not all(n[s] < n[s - 1] for s in events["ImportancePruner"]):
        raise AssertionError("an importance sweep did not lower N")
    for s in events["SHCuller"]:
        before, after = watch["degrees"][s - 1], watch["degrees"][s]
        log(f"phase 14: SH cull after step {s}: degrees 0-3 {before} -> {after}")
        if not sum(after[:3]) > sum(before[:3]):
            raise AssertionError(f"the SH cull after step {s} lowered no degree")

    bars = result["bars"]
    checks = {
        "psnr_final": result["psnr_final"] >= bars["psnr_final_min"],
        "psnr_gain": result["psnr_final"] - result["psnr_init"] >= bars["psnr_gain_min"],
        "reduction_vs_unpruned": (result["reduction_vs_unpruned"]
                                  >= bars["reduction_vs_unpruned_min"]),
        "size_ratio": result["size_ratio"] <= bars["size_ratio_max"]}
    log(f"phase 14: bars {checks}, bars_ok {result['bars_ok']}")
    if not all(checks.values()) or result["bars_ok"] is not True:
        raise AssertionError(f"phase 14 missed a bar: {checks}")

    medians = {}
    times = watch["times"]
    for tag in ("reduced", "baseline"):
        split, *medians[tag] = step_times(times[tag], watch["events"][tag], rows, iters)
        log(f"phase 14 [{card}]: {tag} run, seconds of steps 2-{iters} {split}")
    log(f"phase 14 [{card}]: seconds before the first step (scene, GT renders, init "
        f"evaluation) {times['reduced'][1] - t0:.3f}, between the runs (last evaluation, "
        f"checkpoint, PLYs, quantization, the baseline's start) "
        f"{times['baseline'][1] - times['reduced'][iters]:.3f}, after the last step "
        f"{t_end - times['baseline'][iters]:.3f}")
    # The quantized PLY loaded back, at the same evaluation views and SH degree.
    scene = cp.build_scene(cfg, n_cams, cfg["noise"], "cuda")
    quantized = VariableSHGaussianModel(3, device="cuda")
    ExcludeZeroSHQuantizer().load_quantized(quantized, os.path.join(workdir, cp.QUANTIZED_PLY))
    quantized.active_sh_degree = watch["sh_degree"]
    psnr_q = cp.eval_psnr(quantized, scene.cameras)
    log(f"phase 14 [{card}]: {wall:.1f} s for both runs; median ordinary step "
        f"{medians['reduced'][0]:.3f} ms over {medians['reduced'][1]} steps (flagship), "
        f"{medians['baseline'][0]:.3f} ms over {medians['baseline'][1]} (baseline); peak "
        f"memory {peak_gib:.3f} GiB; reading: the quantized PLY loaded back "
        f"({quantized.num_points} points, SH degree {watch['sh_degree']}) {psnr_q:.4f} dB "
        f"against {result['history'][-1]['psnr']:.4f} dB of the trained model")
    if quantized.num_points != result["n_points_final"] or not math.isfinite(psnr_q):
        raise AssertionError("the quantized PLY does not load back whole")
    return launches, expected["composite_fwd_stats"]


def sync_error(fn):
    """Run fn() with torch.cuda.set_sync_debug_mode("error"): None, or the
    first line of what it raised at a host sync and the port's innermost
    line that called it."""
    import traceback
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "reduced_3dgs_torch" in f.filename]
        where = (f" at {os.path.relpath(frames[-1].filename)}:{frames[-1].lineno} "
                 f"({frames[-1].line})" if frames else "")
        return str(e).strip().splitlines()[0] + where
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return None


def predicted_windows(steps, n_views, event_steps, advance_steps, window_max):
    """The windows train.training takes, from the schedule alone: each
    grows until a step after which an event fires or a schedule advances,
    the end of the epoch or the end of training."""
    windows, step = [], 1
    while step <= steps:
        k = 1
        while (k < window_max and step - 1 + k not in event_steps
               and step - 1 + k not in advance_steps):
            k += 1
        k = min(k, n_views - (step - 1) % n_views, steps - step + 1)
        windows.append((step, k))
        step += k
    return windows


def tail_costs(card, model, camera):
    """Phase 15 (c): at the bench scene with the key buffer at twice its
    entries, the per-Gaussian sum of the backward's per-entry gradients
    (index_add_) with the tail's ids spread over composite.TAIL_SCRATCH
    scratch rows, beside one scratch row for the whole tail and the exact
    buffer's sum; and the Gaussian-id fill as a running count, beside
    torch.cummax's running maximum (JAX's form)."""
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    from reduced_3dgs_torch.ops.rasterize.composite import sum_per_gaussian
    n = model.num_points
    settings = model.render_settings(camera)
    tx, ty = common.tile_grid(settings)
    with torch.no_grad():
        pre = common.preprocess(*model.render_array_args(), settings)
    args = (pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths, tx, ty)
    exact = tiled.bin_and_sort(*args)
    total = exact["num_rendered"]
    K = 2 * total
    ent = tiled.bin_and_sort(*args, key_buffer_size=K)
    gen = torch.Generator(device=model._xyz.device).manual_seed(5)
    g = torch.randn((10, K), device=model._xyz.device, generator=gen)
    one_row = torch.where(ent["valid"], ent["s_gidx"], n)
    counts = torch.where(pre.tiles_touched > 0,
                         (pre.rect_max[:, 0] - pre.rect_min[:, 0]).long()
                         * (pre.rect_max[:, 1] - pre.rect_min[:, 1]).clamp(min=0).long(), 0)
    offsets = torch.cumsum(counts, 0) - counts

    def running_max():
        seed = torch.zeros(K + 1, dtype=torch.int64, device=offsets.device)
        seed.scatter_reduce_(0, torch.where((counts > 0) & (offsets < K), offsets, K),
                             torch.arange(n, device=offsets.device), reduce="amax")
        return torch.cummax(seed[:K], 0).values

    if not torch.equal(running_max(), tiled.fill_ids_from_offsets(offsets, counts, K)):
        raise AssertionError("phase 15 (c): the running count's ids differ from cummax's")
    times = dict(
        spread=cuda_ms(lambda: sum_per_gaussian(g, ent["s_gidx"], n)),
        one_row=cuda_ms(lambda: torch.zeros((10, n + 1), device=g.device).index_add_(
            1, one_row, g)),
        exact=cuda_ms(lambda: sum_per_gaussian(g[:, :total].contiguous(), exact["s_gidx"], n)),
        count_fill=cuda_ms(lambda: tiled.fill_ids_from_offsets(offsets, counts, K)),
        cummax_fill=cuda_ms(running_max))
    log(f"phase 15 (c) [{card}]: key buffer {K} for {total} entries: the per-Gaussian sum "
        f"{times['spread']:.4f} ms with the tail's ids spread over scratch rows "
        f"(one scratch row {times['one_row']:.4f} ms; the exact buffer {times['exact']:.4f} "
        f"ms); the id fill by running count {times['count_fill']:.4f} ms (torch.cummax "
        f"{times['cummax_fill']:.4f} ms)")


def window_phase(card, params_p, src, wrappers, tmp, dense_config):
    """Phase 15: the fused step windows (trainer.step_many, CUDA graphs).
    (a) one eager fixed-shape step of the 3DGS and of the 2DGS model at the
    bench scene under the sync debug mode, and a captured window of each;
    (b) a window of WINDOW steps
    against WINDOW single steps, and the key buffer's tail; (c) the windowed
    step's time beside Trainer.step's, one window's idle share, the
    capture's time and memory, K after two drains; (d) phase 9's flagship
    through train.training with R3DGS_WINDOW=16. Returns (d)'s launches."""
    from reduced_3dgs_torch.combinations import (
        SHCullingOpacityResetFullReducedDensificationTrainer)
    from reduced_3dgs_torch.dataset.dataset import prepare_dataset
    from reduced_3dgs_torch.ops.rasterize.launches import pool_size
    from reduced_3dgs_torch.shculling import (VariableSHGaussianModel,
                                              VariableSHGsplat2DGSGaussianModel)
    from reduced_3dgs_torch.train import training
    from reduced_3dgs_torch.trainer import Trainer

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    dataset = prepare_dataset(src)
    cams = [dataset[i % len(dataset)] for i in range(WINDOW)]

    def trainer_at(cls=VariableSHGaussianModel, source=params_p):
        model = cls(3, device=dev).load_numpy(source)
        trainer = Trainer(model, dataset)
        model.active_sh_degree = 3
        return trainer

    # (a) The sync check: the step a window captures, eagerly, after one
    # step that loads the kernels; then a window of 3 (one eager step, the
    # capture, two replays) against 3 single steps.
    for cls in (VariableSHGaussianModel, VariableSHGsplat2DGSGaussianModel):
        trainer = trainer_at(cls)
        trainer.step(cams[0])
        err = sync_error(lambda: trainer.window_step(trainer, cams[1]))
        del trainer
        log(f"phase 15 (a): {cls.__name__}'s step under the sync debug mode: "
            f"{'no host sync' if err is None else 'synced: ' + err}")
        if err is not None:
            raise AssertionError(f"phase 15 (a): {cls.__name__}'s step syncs; a window "
                                 "captures it")
        windowed, single = trainer_at(cls), trainer_at(cls)
        lw = torch.stack(windowed.step_many(cams[:3])[0]).cpu().double()
        ls = torch.stack([single.step(c)[0] for c in cams[:3]]).cpu().double()
        graph = windowed._graph
        loss_rel = float(((lw - ls).abs() / ls.abs()).max())
        t_walk = time.perf_counter()
        pool = pool_size(graph.graph)
        walk_ms = (time.perf_counter() - t_walk) * 1e3
        log(f"phase 15 (a) [{card}]: {cls.__name__}: a window of 3 steps, captured in "
            f"{graph.capture_s * 1e3:.1f} ms with {pool_mib(pool)} pool (the snapshot walk "
            f"that sizes it {walk_ms:.2f} ms, made only under a profiler), against 3 single "
            f"steps: losses max relative difference {loss_rel:.3e}")
        if not loss_rel <= TOL_CKPT_LOSS_REL:
            raise AssertionError(f"phase 15 (a): {cls.__name__}'s window's losses differ by "
                                 f"{loss_rel:.3e}")
        del windowed, single, graph
        torch.cuda.empty_cache()

    # (b) A window against single steps, from one state, and single steps
    # again for the atomics' spread.
    windowed, single, again = trainer_at(), trainer_at(), trainer_at()
    losses_w, _ = windowed.step_many(cams)
    losses_s = [single.step(c)[0] for c in cams]
    for c in cams:
        again.step(c)
    lw, ls = torch.stack(losses_w).cpu().double(), torch.stack(losses_s).cpu().double()
    loss_rel = float(((lw - ls).abs() / ls.abs()).max())

    def outside(a, b):
        """(max |a - b|, entries of a outside b's gradient bars)."""
        a, b = a.detach().double(), b.detach().double()
        excess = (a - b).abs() - (TOL_CKPT_ATOL + TOL_CKPT_RTOL * b.abs())
        return float((a - b).abs().max()), int((excess > 0).sum())

    failures, table = [], []
    states = [(name, p, single.model.param_dict()[name], again.model.param_dict()[name])
              for name, p in windowed.model.param_dict().items()]
    states += [(name, getattr(windowed, name), getattr(single, name), getattr(again, name))
               for name in ("xyz_grad_accum", "max_radii2d")]
    for name, w, s, a in states:
        (w_max, w_out), (a_max, a_out) = outside(w, s), outside(a, s)
        table.append(f"{name} {w_max:.3e} ({w_out} of {s.numel()} outside; single steps "
                     f"again {a_max:.3e}, {a_out})")
        if w_out > WINDOW_OUTSIDE_SHARE * s.numel():
            failures.append(f"{name}: {w_out} of {s.numel()} entries outside the bars")
    if not torch.equal(windowed.xyz_grad_denom, single.xyz_grad_denom):
        failures.append("xyz_grad_denom differs")
    graph = windowed._graph
    log(f"phase 15 (b) [{card}]: a window of {WINDOW} steps (one captured graph, "
        f"{graph.tally} launches a replay) against {WINDOW} single steps: losses max relative "
        f"difference {loss_rel:.3e}; max |difference| " + ", ".join(table))
    if not loss_rel <= TOL_CKPT_LOSS_REL:
        failures.append(f"losses differ by {loss_rel:.3e} (relative)")
    del windowed, single, again, graph
    torch.cuda.empty_cache()

    # The buffer's tail: one render at the exact entry count and at twice
    # it, of the bench scene and of the 2DGS model of its MERCY_SUBSET
    # Gaussians of smallest x.
    subset = np.argsort(params_p["xyz"][:, 0], kind="stable")[:MERCY_SUBSET]
    for cls, source in ((VariableSHGaussianModel, params_p),
                        (VariableSHGsplat2DGSGaussianModel,
                         {k: v[subset] for k, v in params_p.items()})):
        grads, total = {}, None
        for factor in (1, 2):
            trainer = trainer_at(cls, source)
            model = trainer.model
            if total is None:
                with torch.no_grad():
                    total = model.render(cams[0])["num_rendered"]
            out = model.render(cams[0], key_buffer_size=factor * total)
            loss = trainer.loss_pure()(model.param_dict(), out, cams[0], {})
            loss.backward()
            grads[factor] = {k: p.grad.detach().clone() for k, p in model.param_dict().items()}
            del trainer, model, out, loss
        tail_rel = {k: float((grads[2][k] - g).abs().max() / g.abs().max())
                    for k, g in grads[1].items()}
        log(f"phase 15 (b) [{card}]: {cls.__name__} at N={len(source['xyz'])}: gradient with "
            f"the key buffer at {2 * total} against {total} (exact): max |difference| / max "
            f"|gradient| " + ", ".join(f"{k} {v:.3e}" for k, v in tail_rel.items()))
        if not all(math.isfinite(v) and v <= TOL_BWD_REL for v in tail_rel.values()):
            failures.append(f"{cls.__name__}: the buffer's tail moves the gradient: {tail_rel}")
        del grads
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 15 (b): " + "; ".join(failures))

    # (c) Times: windows, then a window under the profiler; Trainer.step.
    trainer = trainer_at()
    window_ms, graphs = [], []
    for it in range(WINDOW_WARMUP + WINDOW_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step_many(cams)
        end.record()
        end.synchronize()
        window_ms.append(start.elapsed_time(end))
        graphs.append(trainer._graph)
    busy = device_busy(lambda: trainer.step_many(cams), calls=1)
    fresh = [i for i, g in enumerate(graphs) if i == 0 or g is not graphs[i - 1]]
    captures = [graphs[i] for i in fresh]
    key_buffer = trainer.key_buffer_for(cams[0])
    with torch.no_grad():
        rendered = trainer.model.render(cams[0])["num_rendered"]
    single = trainer_at()
    step_ms = cuda_ms(lambda: single.step(cams[0]))
    del single
    timed = window_ms[WINDOW_WARMUP:]
    n_launch, busy_ms, wall_ms, top, _ = busy
    log(f"phase 15 (c) [{card}]: windows of {WINDOW} steps at N={N_GAUSSIANS}, {HEIGHT}x{WIDTH}, "
        f"SH degree 3: {[round(t, 4) for t in window_ms]} ms (the first {WINDOW_WARMUP} warm-up); "
        f"timed median {statistics.median(timed):.4f} ms, "
        f"{statistics.median(timed) / WINDOW:.4f} ms a step; Trainer.step {step_ms:.4f} ms")
    log(f"phase 15 (c) [{card}]: {len(captures)} captures in {trainer.curr_step} steps, in "
        f"windows {[i + 1 for i in fresh]}: capture "
        + ", ".join(f"{g.capture_s * 1e3:.1f} ms and {pool_mib(g.pool_bytes)} pool"
                    for g in captures)
        + f"; after two drains K {key_buffer} for {rendered} entries "
        f"({key_buffer / rendered:.3f}x)")
    if busy_ms > 0:
        log(f"phase 15 (c) [{card}]: under torch.profiler, one window of {WINDOW} steps: "
            f"{n_launch:.0f} device kernels and copies, device busy {busy_ms:.4f} ms of "
            f"{wall_ms:.4f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}); top: "
            + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
    else:
        log("phase 15 (c): the window's device busy share not measured (the profiler saw "
            "no device time)")
    tail_costs(card, trainer.model, cams[0])
    del trainer, graphs, captures
    torch.cuda.empty_cache()

    # (d) Phase 9's flagship through train.training, in windows.
    config = dict(FLAGSHIP_CONFIG, **{k: dense_config[k] for k in (
        "densify_grad_threshold", "densify_percent_dense", "prune_percent_too_big")})
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    trainer = SHCullingOpacityResetFullReducedDensificationTrainer(model, dataset, **config)
    windows = []
    take_step, take_many = trainer.step, trainer.step_many

    def record(fn, k):
        def run(cameras):
            first, n0 = trainer.curr_step + 1, model.num_points
            out = fn(cameras)
            windows.append((first, k(cameras), n0, model.num_points))
            return out
        return run

    trainer.step = record(take_step, lambda c: 1)
    trainer.step_many = record(take_many, len)
    for fn in wrappers.values():
        fn.launches = 0
    os.environ["R3DGS_WINDOW"] = str(WINDOW)
    t0 = time.perf_counter()
    try:
        losses = training(dataset, model, trainer, None, os.path.join(tmp, "windows"),
                          iteration=FLAGSHIP_STEPS, save_iterations=[])
        torch.cuda.synchronize()
    finally:
        os.environ["R3DGS_WINDOW"] = "1"
        trainer.step, trainer.step_many = take_step, take_many
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    values = torch.stack(losses).cpu().tolist()
    instruction_steps = set(F_SPLIT + F_PRUNE + F_IMPORTANCE)
    advance_steps = {s for s in range(FLAGSHIP_STEPS)
                     if s > 0 and s % FLAGSHIP_CONFIG["sh_degree_up_interval"] == 0
                     and s // FLAGSHIP_CONFIG["sh_degree_up_interval"] <= 3}
    expected_windows = predicted_windows(
        FLAGSHIP_STEPS, len(dataset), set(F_SPLIT + F_PRUNE + F_IMPORTANCE + F_CULL + F_RESET),
        advance_steps, WINDOW)
    log(f"phase 15 (d) [{card}]: training() {FLAGSHIP_STEPS} steps of the flagship with "
        f"R3DGS_WINDOW={WINDOW} in {wall:.2f} s: windows (first step, steps, N before, N "
        f"after) {windows}; losses {values}; launches {launches}")
    failures = []
    if [(w[0], w[1]) for w in windows] != expected_windows:
        failures.append(f"windows {[(w[0], w[1]) for w in windows]}, the schedule's "
                        f"{expected_windows}")
    for first, k, n0, n1 in windows:
        if n1 != n0 and first + k - 1 not in instruction_steps:
            failures.append(f"N moved in the window ending after step {first + k - 1}")
    expected = preprocess_expected({
        "composite_fwd": FLAGSHIP_STEPS, "composite_bwd": FLAGSHIP_STEPS,
        "composite_fwd_stats": len(dataset) * (len(F_IMPORTANCE) + 2 * len(F_CULL))},
        adam=FLAGSHIP_STEPS)
    if launches != expected:
        failures.append(f"launched {launches}, expected {expected}")
    if len(values) != FLAGSHIP_STEPS or not all(map(math.isfinite, values)):
        failures.append(f"losses are not all finite: {values}")
    if failures:
        raise AssertionError("phase 15 (d): " + "; ".join(failures))
    log(f"phase 15 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    return launches


def sweep_poses(n):
    """n COLMAP poses spread over the range of view_poses' four: rotations
    about y within +-0.045 and about x of +-0.01, translations within theirs."""
    poses = []
    for i in range(n):
        u = i / max(n - 1, 1)
        a, b = 0.09 * (u - 0.5), 0.02 * ((i % 2) - 0.5)
        q = np.array([math.cos(a / 2) * math.cos(b / 2), math.sin(b / 2) * math.cos(a / 2),
                      math.sin(a / 2) * math.cos(b / 2), -math.sin(a / 2) * math.sin(b / 2)])
        poses.append((q / np.linalg.norm(q),
                      np.array([0.075 * (2 * u - 1), 0.02 * (i % 2), 0.09 * u])))
    return poses


class eager_sweeps:
    """Within it the sweeps take the eager exact per-view loop, as for
    cameras that are not stackable."""

    def __enter__(self):
        from reduced_3dgs_torch.dataset import camera as camera_mod
        self.module, self.stackable = camera_mod, camera_mod.stackable
        camera_mod.stackable = lambda cameras: False

    def __exit__(self, *exc):
        self.module.stackable = self.stackable


class counting_regrows:
    """Within it, ``count`` is the number of key buffers the event sweeps
    regrew and wrote back to their engine (``BaseTrainer.sweep_buffer``):
    each is one more pass of the statistics compositor over the views."""

    def __enter__(self):
        from reduced_3dgs_torch.trainer import BaseTrainer
        self.cls, self.set, self.count = BaseTrainer, BaseTrainer.set_key_buffer, 0

        def counting(engine, camera, size):
            self.count += 1
            self.set(engine, camera, size)

        BaseTrainer.set_key_buffer = counting
        return self

    def __exit__(self, *exc):
        self.cls.set_key_buffer = self.set


def cull_thresholds(model, cams):
    """(std threshold, distance threshold, near): thresholds of the SH cull
    that split ``model``'s Gaussians over ``cams``, each halfway between two
    neighbouring values of the eager passes' statistics (the 40th percentile
    of the colour std; the median band-1 distance of the Gaussians the
    first pass leaves above degree 0), and the [N] bool mask of the
    Gaussians whose decision lies within DECISION_MARGIN of its threshold."""
    from reduced_3dgs_torch.ops.shculling_stats import calculate_colours_variance
    from reduced_3dgs_torch.shculling.trainer import _low_variance_colour_culling

    def between(values, q):
        v = torch.unique(values.double())
        i = int(q * (v.numel() - 1))
        return float((v[i] + v[i + 1]) / 2)

    params = {k: p.detach() for k, p in model.param_dict().items()}
    degrees = model._degrees
    with eager_sweeps():
        _, var, mean = calculate_colours_variance(cams, model, params, degrees, 3)
        std = torch.nan_to_num(torch.sqrt(var)).mean(dim=2)[:, 0]
        std_thr = between(std, 0.4)
        d2, dc, rest = _low_variance_colour_culling(
            degrees, params["features_dc"], params["features_rest"], std_thr, var, mean)
        dist = torch.nan_to_num(calculate_colours_variance(
            cams, model, dict(params, features_dc=dc, features_rest=rest), d2, 3)[0])
    cdist = between(dist[d2 > 0, 1], 0.5)
    near = (std - std_thr).abs() <= DECISION_MARGIN * std_thr
    near |= ((dist[:, 1:3] - cdist).abs() <= DECISION_MARGIN * cdist).any(dim=1)
    return std_thr, cdist, near


def compare_sweeps(card, model, cams, label):
    """The static sweeps of ``model`` over ``cams`` (on the card, sweep
    graphs for views of one FoV) against the eager exact loop: the importance counts (exact) and scores (within TOL_STATS_REL of
    the largest), then the SH cull of two copies of ``model`` at
    ``cull_thresholds`` (degrees equal but near a threshold, features
    within TOL_SWEEP_FEATURES). Raises on a difference; returns the graph
    sweeps' compositor launches."""
    from reduced_3dgs_torch.importance import trainer as imp
    from reduced_3dgs_torch.ops.rasterize import composite
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel, cull_sh_bands
    wrappers = with_preprocess({"composite_fwd": composite.composite_fwd,
                                "composite_fwd_stats": composite.composite_fwd_stats,
                                "composite_bwd": composite.composite_bwd})
    params = {k: p.detach().cpu().numpy() for k, p in model.param_dict().items()}
    degrees = model._degrees.cpu().numpy()
    culled = {how: VariableSHGaussianModel(3, device=model._xyz.device).load_numpy(params,
                                                                                   degrees)
              for how in ("graph", "eager")}
    std_thr, cdist, near = cull_thresholds(model, cams)

    def graph_sweeps():
        counts = imp.prune_list(model, cams)
        cull_sh_bands(culled["graph"], cams, cdist, std_thr)
        return counts

    graph, launches = counted(wrappers, graph_sweeps)
    # A pass launches the statistics compositor once per view.
    passes = launches["composite_fwd_stats"] / len(cams)
    exact = imp.exact_counts(model, cams)
    with eager_sweeps():
        cull_sh_bands(culled["eager"], cams, cdist, std_thr)
    failures = []
    if launches != preprocess_expected({"composite_fwd": 0, "composite_fwd_stats": 3 * len(cams),
                                        "composite_bwd": 0}):
        failures.append(f"launched {launches}: {passes:g} passes, not one a sweep")
    count_diff = int((graph[0] != exact[0]).sum())
    score_rel = [float((g - e).abs().max() / e.abs().max()) for g, e in zip(graph[1:], exact[1:])]
    if count_diff or not all(r <= TOL_STATS_REL for r in score_rel):
        failures.append(f"importance: {count_diff} counts differ, scores {score_rel}")
    deg_g, deg_e = culled["graph"]._degrees, culled["eager"]._degrees
    differ = deg_g != deg_e
    same = ~differ
    feat_err = {k: float((culled["graph"].param_dict()[k] - culled["eager"].param_dict()[k])
                         .detach()[same].abs().max())
                for k in ("features_dc", "features_rest")}
    if (differ & ~near).any():
        failures.append(f"{int((differ & ~near).sum())} degrees differ away from a threshold")
    if not all(v <= TOL_SWEEP_FEATURES for v in feat_err.values()):
        failures.append(f"features differ by {feat_err}")
    hist = torch.bincount(deg_g.long(), minlength=4).tolist()
    if not (hist[0] > 0 and sum(hist[1:3]) > 0 and hist[3] > 0):
        failures.append(f"the cull left degrees {hist}: the thresholds split nothing")
    log(f"phase 16 (b) [{card}]: {label}: static sweeps over {len(cams)} views against the "
        f"eager exact loop: {passes:g} passes, launches {launches}; importance counts differing "
        f"{count_diff} of {exact[0].numel()}, scores max |difference| / max |value| "
        f"{score_rel[0]:.3e} (opacity), {score_rel[1]:.3e} (T_alpha); cull at std {std_thr:.6g} "
        f"and distance {cdist:.6g}: degrees 0-3 {hist}, "
        f"differing {int(differ.sum())} (within {DECISION_MARGIN} of a threshold "
        f"{int(near.sum())}), features max |difference| {feat_err}")
    if failures:
        raise AssertionError(f"phase 16 (b) {label}: " + "; ".join(failures))
    return launches


def sweep_phase(card, params, b2_runs):
    """Phase 16: the one-program event sweeps. (a) the per-view bodies under
    the sync debug mode; (b) the graph sweeps against the eager exact loop;
    (c) times at SWEEP_VIEWS views (the eager loop, the graph sweep as an
    event runs it, a capture included, and a graph's replays alone), the
    captures, K and the idle shares; (d) a forced overflow; (e)
    ``b2_runs``, {phase: (the statistics compositor's launches, its
    schedule's)}. Returns (b)'s launches."""
    from reduced_3dgs_torch.dataset.camera import sweep_cameras
    from reduced_3dgs_torch.importance import trainer as imp
    from reduced_3dgs_torch.ops import shculling_stats as stats
    from reduced_3dgs_torch.ops.rasterize import composite, sweep
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel, cull_sh_bands
    from reduced_3dgs_torch.trainer import BaseTrainer

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    views = {n: sweep_cameras([view_camera(p, dev) for p in sweep_poses(n)])
             for n in SWEEP_VIEWS}
    cams = views[N_VIEWS]
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    n = model.num_points
    with torch.no_grad():
        entries = {nv: [int(model.render(c)["num_rendered"]) for c in vs]
                   for nv, vs in views.items()}
    K = sweep.start_key_buffer(n, cams[0])
    p = {k: v.detach() for k, v in model.param_dict().items()}

    def bodies():
        """Each sweep's body at the starting K, over new accumulators."""
        return {"importance": imp.counts_body(K, imp.count_accumulators(n, dev)),
                "colours": stats.colours_body(p, model._degrees, 3)(
                    K, stats.colour_accumulators(n, 3, dev))}

    # (a) Each body at the starting K, eagerly, after one call that loads
    # the kernels.
    errors = {}
    with torch.no_grad():
        for kind, body in bodies().items():
            body(model, cams[0])
            errors[kind] = sync_error(lambda: body(model, cams[1]))
    log(f"phase 16 (a): the sweep bodies under the sync debug mode at K={K}: "
        + ", ".join(f"{k} {'no host sync' if e is None else 'synced: ' + e}"
                    for k, e in errors.items()))
    if any(e is not None for e in errors.values()):
        raise AssertionError(f"phase 16 (a): a sweep body syncs: {errors}")

    # (b) The graph sweeps against the eager exact loop.
    launches = compare_sweeps(card, model, cams, "bench scene")

    # (c) Times, the captures and the idle share.
    cull_model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    start_dc = cull_model._features_dc.detach().clone()
    start_rest = cull_model._features_rest.detach().clone()

    def reset_cull_model():
        with torch.no_grad():
            cull_model._features_dc.copy_(start_dc)
            cull_model._features_rest.copy_(start_rest)
        cull_model.init_degrees()

    def replays(graph, vs):
        for c in vs:
            graph.replay(c)

    times = {}
    for nv, vs in views.items():
        reps = REPEATS if nv == N_VIEWS else SWEEP_REPEATS
        with torch.no_grad():
            eager_ms = cuda_ms(lambda: imp.exact_counts(model, vs), warmup=1, repeats=reps)
            graph_ms = cuda_ms(lambda: imp.prune_list(model, vs), warmup=1, repeats=reps)
            # A graph of each body, captured on the first view, for the
            # replays' time and the capture's.
            graphs = {kind: sweep.SweepGraph(model, body, vs[0])
                      for kind, body in bodies().items()}
            replay_ms = cuda_ms(lambda: replays(graphs["importance"], vs), warmup=1,
                                repeats=reps)
        with eager_sweeps():
            cull_eager_ms = cuda_ms(lambda: cull_sh_bands(cull_model, vs, CULL_CDIST, CULL_STD),
                                    warmup=1, repeats=reps, setup=reset_cull_model)
        cull_graph_ms = cuda_ms(lambda: cull_sh_bands(cull_model, vs, CULL_CDIST, CULL_STD),
                                warmup=1, repeats=reps, setup=reset_cull_model)
        times[nv] = dict(eager=eager_ms, graph=graph_ms, replay=replay_ms,
                         cull_eager=cull_eager_ms, cull_graph=cull_graph_ms)
        log(f"phase 16 (c) [{card}]: {nv} views of {HEIGHT}x{WIDTH} at N={n}, SH degree 3 "
            f"(median of {reps}): importance sweep eager {eager_ms:.4f} ms "
            f"({eager_ms / nv:.4f} a view), graph sweep {graph_ms:.4f} ms "
            f"({graph_ms / nv:.4f} a view, an eager view and the capture included), a "
            f"graph's replays alone {replay_ms:.4f} ms ({replay_ms / nv:.4f} a view); SH cull "
            f"eager {cull_eager_ms:.4f} ms ({cull_eager_ms / (2 * nv):.4f} a view-pass), graph "
            f"{cull_graph_ms:.4f} ms ({cull_graph_ms / (2 * nv):.4f} a view-pass, two captures "
            f"included)")
        log(f"phase 16 (c) [{card}]: {nv} views: capture "
            + ", ".join(f"{kind} {g.capture_s * 1e3:.1f} ms and {pool_mib(g.pool_bytes)} pool"
                        for kind, g in graphs.items())
            + f"; K {K} for at most {max(entries[nv])} entries a view (mean "
            f"{statistics.mean(entries[nv]):.0f}; K / max {K / max(entries[nv]):.3f})")
        if nv != SWEEP_VIEWS[-1]:
            del graphs
    v64 = views[SWEEP_VIEWS[-1]]
    with torch.no_grad():
        busy = {"importance sweep (a graph's replays alone)": device_busy(
                    lambda: replays(graphs["importance"], v64), calls=1)}
        del graphs
        busy["importance sweep (graph, capture included)"] = device_busy(
            lambda: imp.prune_list(model, v64), calls=1)
    busy["SH cull (graphs)"] = device_busy(
        lambda: (reset_cull_model(), cull_sh_bands(cull_model, v64, CULL_CDIST, CULL_STD)),
        calls=1)
    with torch.no_grad():
        busy["importance sweep (eager loop)"] = device_busy(
            lambda: imp.exact_counts(model, v64), calls=1)
    for what, (n_launch, busy_ms, wall_ms, top, _) in busy.items():
        if busy_ms > 0:
            log(f"phase 16 (c) [{card}]: under torch.profiler, one {what} over {len(v64)} "
                f"views: {n_launch:.0f} device kernels and copies, device busy {busy_ms:.4f} "
                f"ms of {wall_ms:.4f} ms wall (idle share {1 - busy_ms / wall_ms:.3f}); top: "
                + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in top))
        else:
            log(f"phase 16 (c): the {what}'s device busy share not measured (the profiler "
                "saw no device time)")
    del cull_model, start_dc, start_rest

    # (d) A forced overflow, through an engine whose buffer is too small.
    engine = BaseTrainer(model)
    start = max(entries[N_VIEWS]) // SWEEP_OVERFLOW_DIVISOR
    engine.set_key_buffer(cams[0], start)
    regrown, ovf_launches = counted(
        {"composite_fwd_stats": composite.composite_fwd_stats},
        lambda: imp.prune_list(model, cams, engine=engine))
    passes = ovf_launches["composite_fwd_stats"] / len(cams)
    exact = imp.exact_counts(model, cams)
    k_after = engine.held_key_buffer(cams[0])
    score_rel = [float((g - e).abs().max() / e.abs().max()) for g, e in zip(regrown[1:], exact[1:])]
    log(f"phase 16 (d) [{card}]: from K={start} ({max(entries[N_VIEWS])} entries in the largest "
        f"view): {passes:g} passes (statistics compositor launches "
        f"{ovf_launches['composite_fwd_stats']} over {len(cams)} views), K regrown to {k_after} "
        f"and written back to the engine; counts equal the exact sweep's "
        f"{bool(torch.equal(regrown[0], exact[0]))}, scores {score_rel}")
    if not (passes >= 2 and passes == int(passes) and k_after >= max(entries[N_VIEWS])
            and torch.equal(regrown[0], exact[0]) and all(r <= TOL_STATS_REL for r in score_rel)):
        raise AssertionError("phase 16 (d): the forced overflow did not regrow to the exact "
                             "sweep's sums")
    del engine

    # (e) The statistics compositor's launches on the training paths.
    log(f"phase 16 (e): statistics compositor launches on the training paths (launched, "
        f"schedule's): {b2_runs}")
    wrong = {k: v for k, v in b2_runs.items() if v[0] != v[1]}
    if wrong:
        raise AssertionError(f"phase 16 (e): launches off their schedule: {wrong}")
    log(f"phase 16 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 17: the preprocess at the training step's size.
PREPROCESS_LARGE_N = 1_250_000
# The card's device memory bandwidth (H100 SXM data sheet), bytes/s.
DRAM_BYTES_PER_S = 3.35e12


def preprocess_bytes(n, sh_floats, backward):
    """The bytes the preprocess kernels must move for n Gaussians at an SH
    row of sh_floats floats, with the NDC offset: the forward reads means,
    the opacity logit, scales, rotation, the SH row and the offset and writes
    the ten fields, radius, rects and tile count; the backward reads the
    same inputs but the offset, and the field gradient, and writes every
    gradient. Each byte once."""
    inputs = 4 * (3 + 1 + 3 + 4 + sh_floats)
    if backward:
        return n * (inputs + 4 * 10 + inputs + 4 * 2)
    return n * (inputs + 4 * 2 + 4 * 10 + 4 * (1 + 2 + 2 + 1))


def preprocess_phase(card, launches_by_phase):
    """Phase 17 (see the module docstring). Returns the kernels' records for
    the last line, with the launches of phases 11, 14, 15 and 16
    (``launches_by_phase``)."""
    from reduced_3dgs_torch.ops.rasterize import common, composite
    from reduced_3dgs_torch.ops.rasterize import preprocess_kernel as pk
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    rows = {}
    camera_names = ("viewmatrix", "projmatrix", "campos")
    names = ("means3d", "opacities_raw", "scales", "rotations", "shs",
             "mean2d_offset_ndc") + camera_names
    for label, n in (("bench", N_GAUSSIANS), ("1.25M", PREPROCESS_LARGE_N)):
        model = VariableSHGaussianModel(3, device=dev).load_numpy(bench_scene(0, n))
        s = model.render_settings(view_camera(view_poses()[0], dev))
        arrays = [a.detach().contiguous() for a in model.render_array_args()]
        cam = (s.viewmatrix, s.projmatrix, s.campos)
        off = torch.zeros((n, 2), device=dev)
        g = torch.randn((composite.N_FIELDS, n), device=dev)
        train = (True,) * 6 + (False,) * 4
        with_camera = (True,) * 6 + (False,) + (True,) * 3

        def leaves(dtype, camera):
            out = [t.detach().to(dtype).clone().requires_grad_(True) for t in arrays + [off]]
            cams = [t.detach().to(dtype).clone().requires_grad_(camera) for t in cam]
            return out, cams

        def plain_fields(ls, cams):
            st = s._replace(viewmatrix=cams[0], projmatrix=cams[1], campos=cams[2])
            return common.preprocess_plain(*ls[:5], st, ls[5]).fields

        def kernel_fields(ls, cams):
            return pk.Preprocess.apply(*ls[:5], ls[5], None, *cams, s)[0]

        def grads(fields_of, dtype, camera):
            ls, cams = leaves(dtype, camera)
            wrt = ls + (cams if camera else [])
            got = torch.autograd.grad((fields_of(ls, cams) * g.to(dtype)).sum(), wrt)
            return dict(zip(names, got))

        def plain_fwd():
            return common.preprocess_plain(*arrays, s, off).fields

        def plain_pair():
            grads(plain_fields, torch.float32, False)

        def kernel_pair():
            grads(kernel_fields, torch.float32, False)

        # The plain backward alone: autograd through one recorded forward.
        ls, cams = leaves(torch.float32, False)
        plain_loss = (plain_fields(ls, cams) * g).sum()
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(plain_loss, ls, retain_graph=True),
                               repeats=10)
        del plain_loss, ls, cams
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: pk.preprocess_fwd(*arrays, off, None, *cam, s))
            bwd_ms = cuda_ms(lambda: pk.preprocess_bwd(g, *arrays, None, *cam, s, train))
            cam_ms = cuda_ms(lambda: pk.preprocess_bwd(g, *arrays, None, *cam, s, with_camera))
            plain_ms = cuda_ms(plain_fwd)
            fwd_dev = kernel_device_ms(device_busy(
                lambda: pk.preprocess_fwd(*arrays, off, None, *cam, s))[4], "preprocess_fwd_kernel")
            bwd_dev = kernel_device_ms(device_busy(
                lambda: pk.preprocess_bwd(g, *arrays, None, *cam, s, train))[4],
                "preprocess_bwd_kernel")
            got = pk.preprocess_fwd(*arrays, off, None, *cam, s)
            want = plain_fwd()
            want_ints = common.preprocess_plain(*arrays, s, off)[5:9]
        pair_ms = cuda_ms(kernel_pair, repeats=10)
        plain_pair_ms = cuda_ms(plain_pair, repeats=10)
        err = float((got[0] - want).abs().max())
        far = int((~torch.isclose(got[0], want, rtol=1e-4, atol=1e-6)).sum())
        off_rows = [int((a != b).reshape(n, -1).any(-1).sum()) for a, b in zip(got[1:], want_ints)]

        # The backward against autograd through the plain version, in the
        # training step's form and with the camera's gradient; the camera
        # form also against autograd in float64, with the plain float32
        # version's distance from it beside the kernel's.
        grad_err, f64_err = {}, {}
        for form, camera in (("train", False), ("with_camera", True)):
            kernel = grads(kernel_fields, torch.float32, camera)
            plain = grads(plain_fields, torch.float32, camera)
            grad_err[form] = {k: float((kernel[k] - plain[k]).norm() / plain[k].norm())
                              for k in kernel}
            if camera:
                exact = grads(plain_fields, torch.float64, True)
                f64_err = {k: (float((kernel[k].double() - exact[k]).norm() / exact[k].norm()),
                               float((plain[k].double() - exact[k]).norm() / exact[k].norm()))
                           for k in exact}
                del exact
            del kernel, plain
        bad = {form: {k: e for k, e in errs.items()
                      if not e <= (1e-3 if k in camera_names else 1e-4)}
               for form, errs in grad_err.items()}
        sh_floats = arrays[4].shape[1] * 3
        fwd_bytes = preprocess_bytes(n, sh_floats, False)
        bwd_bytes = preprocess_bytes(n, sh_floats, True)
        rows[label] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_fwd_ms=plain_ms,
                           plain_bwd_ms=plain_bwd_ms,
                           fwd_err=err, bwd_err=max(max(e.values()) for e in grad_err.values()),
                           fwd_bound=fwd_bytes / DRAM_BYTES_PER_S * 1e3,
                           bwd_bound=bwd_bytes / DRAM_BYTES_PER_S * 1e3)
        device_text = "not measured (the profiler saw no device time)"
        if fwd_dev > 0 and bwd_dev > 0:
            device_text = (
                f"forward {fwd_dev:.4f} ms "
                f"({100 * fwd_bytes / (fwd_dev * 1e-3) / DRAM_BYTES_PER_S:.1f}%), backward "
                f"{bwd_dev:.4f} ms ({100 * bwd_bytes / (bwd_dev * 1e-3) / DRAM_BYTES_PER_S:.1f}%)")
        log(f"phase 17 [{card}]: {label} (N={n}, SH row {sh_floats} floats): forward kernel "
            f"{fwd_ms:.4f} ms ({fwd_bytes / 1e6:.1f} MB, "
            f"{100 * fwd_bytes / (fwd_ms * 1e-3) / DRAM_BYTES_PER_S:.1f}% of "
            f"{DRAM_BYTES_PER_S / 1e12:.2f} TB/s), backward kernel {bwd_ms:.4f} ms "
            f"({bwd_bytes / 1e6:.1f} MB, "
            f"{100 * bwd_bytes / (bwd_ms * 1e-3) / DRAM_BYTES_PER_S:.1f}%), with the camera's "
            f"gradient {cam_ms:.4f} ms; device time under the profiler: {device_text}; "
            f"plain forward {plain_ms:.4f} ms, plain backward (autograd) {plain_bwd_ms:.4f} ms; "
            f"forward and backward through autograd: kernels {pair_ms:.4f} ms, plain "
            f"{plain_pair_ms:.4f} ms; fields max abs err {err:.2e}, {far} values outside 1e-4 "
            f"relative and 1e-6 absolute, rows off (radii, rect_min, rect_max, tiles) "
            f"{off_rows}")
        log(f"phase 17 [{card}]: {label}: |kernel - plain| / |plain| of each gradient (bars "
            f"1e-4, the camera's 1e-3): {json.dumps(grad_err)}; with the camera's, distance "
            f"from float64 autograd (kernel, plain float32): {json.dumps(f64_err)}")
        if far or max(off_rows) > 1e-5 * n:
            raise AssertionError(f"phase 17 [{label}]: the forward kernel left the plain "
                                 f"version: {far} values, {off_rows} rows")
        if any(bad.values()):
            raise AssertionError(f"phase 17 [{label}]: the backward kernel left autograd "
                                 f"through the plain version: {bad}")
        del model, arrays, got, want, g, off
        torch.cuda.empty_cache()
    log(f"phase 17 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    big = rows["1.25M"]
    source = "reduced_3dgs_torch/ops/rasterize/csrc/preprocess.cu"
    records = []
    for kind in ("fwd", "bwd"):
        name = f"preprocess_{kind}"
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": None,
            "launches": sum(launches_by_phase[name].values()),
            "launches_by_phase": launches_by_phase[name],
            # The backward's error is its largest relative norm error of a gradient.
            ("max_abs_err" if kind == "fwd" else "max_rel_norm_err"): big[f"{kind}_err"],
            "ms": big[f"{kind}_ms"], "plain_ms": big[f"plain_{kind}_ms"],
            "bound_ms": big[f"{kind}_bound"], "bound_by": "bytes", "library_ms": None})
    return records


def binning_bytes(n, entries, num_tiles, static):
    """The bytes the binning must move: each Gaussian's rects, tile count
    and depth read once (24 B), each entry's tile id and Gaussian id
    written as int64 and, for a static buffer, its valid flag, and two
    int32 range bounds a tile."""
    return 24 * n + (17 if static else 16) * entries + 8 * num_tiles


def binning_phase(card, launches_by_phase):
    """Phase 18 (see the module docstring). Returns the kernels' records for
    the last line, with the launches of phases 11, 14, 15 and 16
    (``launches_by_phase``)."""
    from reduced_3dgs_torch.ops.rasterize import binning_kernel as bk
    from reduced_3dgs_torch.ops.rasterize import common, tiled
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel
    from reduced_3dgs_torch.trainer.base import KEY_BUFFER_FACTOR
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    rows = {}
    for label, n in (("bench", N_GAUSSIANS), ("1.25M", PREPROCESS_LARGE_N)):
        model = VariableSHGaussianModel(3, device=dev).load_numpy(bench_scene(0, n))
        camera = view_camera(view_poses()[0], dev)
        s = model.render_settings(camera)
        tx, ty = common.tile_grid(s)
        with torch.no_grad():
            pre = common.preprocess(*model.render_array_args(), s)
        args = (pre.rect_min, pre.rect_max, pre.tiles_touched, pre.depths, tx, ty)
        cap = tiled.bucket_capacity(n)       # the trainer's first buffer (key_buffer_for)
        K = min(max(tiled.default_key_buffer_size(cap, tx, ty), KEY_BUFFER_FACTOR * cap),
                tiled.max_key_buffer(cap, tx, ty))
        total = tiled.bin_and_sort(*args)["num_rendered"]
        state = {}

        def count():
            state["c"] = bk.bin_count(*args[:4], ty)

        for name, k in (("static", K), ("exact", None)):
            got = tiled.bin_and_sort(*args, key_buffer_size=k)
            want = tiled.bin_and_sort_plain(*args, key_buffer_size=k)
            torch.cuda.synchronize()
            differ = [key for key in want if not (
                torch.equal(got[key], want[key]) if isinstance(want[key], torch.Tensor)
                else got[key] == want[key])]
            if differ or set(got) != set(want):
                raise AssertionError(f"phase 18 [{label}, {name}]: the kernels' {differ} "
                                     f"differ from the plain binning's")
        entries = min(total, K)
        sort_args = (K, tx, ty, 0, True)
        times = dict(
            count=cuda_ms(lambda: bk.bin_count(*args[:4], ty)),
            sort=cuda_ms(lambda: bk.bin_sort(state["c"], *sort_args), setup=count),
            static=cuda_ms(lambda: tiled.bin_and_sort(*args, key_buffer_size=K)),
            exact=cuda_ms(lambda: tiled.bin_and_sort(*args)),
            plain_static=cuda_ms(lambda: tiled.bin_and_sort_plain(*args, key_buffer_size=K),
                                 repeats=10),
            plain_exact=cuda_ms(lambda: tiled.bin_and_sort_plain(*args), repeats=10))
        stats = device_busy(lambda: tiled.bin_and_sort(*args, key_buffer_size=K))
        plain_stats = device_busy(lambda: tiled.bin_and_sort_plain(*args, key_buffer_size=K))
        by_kernel = {key[:70]: round(ms, 4) for key, ms in sorted(
            stats[4].items(), key=lambda kv: -kv[1])}
        static_bytes = binning_bytes(n, K, tx * ty, True)
        exact_bytes = binning_bytes(n, total, tx * ty, False)
        bound = static_bytes / DRAM_BYTES_PER_S * 1e3
        rows[label] = dict(times, n=n, K=K, total=total, bound=bound, device=stats[1],
                           plain_device=plain_stats[1])
        device_text = "not measured (the profiler saw no device time)"
        if stats[1] > 0:
            device_text = (f"{stats[1]:.4f} ms ({100 * bound / stats[1]:.1f}% of the bound) in "
                           f"{stats[0]:.0f} kernels and copies, by kernel {by_kernel}; the "
                           f"plain static binning {plain_stats[1]:.4f} ms in "
                           f"{plain_stats[0]:.0f}")
        log(f"phase 18 [{card}]: {label} (N={n}, {tx}x{ty} tiles, {total} entries, static "
            f"buffer {K}, {entries} kept): outputs bit for bit the plain binning's, static and "
            f"exact; bin_count {times['count']:.4f} ms, bin_sort {times['sort']:.4f} ms, "
            f"static binning {times['static']:.4f} ms, exact {times['exact']:.4f} ms (with its "
            f"sync); plain static {times['plain_static']:.4f} ms, plain exact "
            f"{times['plain_exact']:.4f} ms; bound {bound:.4f} ms ({static_bytes / 1e6:.1f} "
            f"MB static, {exact_bytes / 1e6:.1f} MB exact, at {DRAM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s), {100 * bound / times['static']:.1f}% by events; device time of the static "
            f"binning under the profiler: {device_text}")
        del model, pre, args, state
        torch.cuda.empty_cache()
    log(f"phase 18 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    big = rows["1.25M"]
    source = "reduced_3dgs_torch/ops/rasterize/csrc/binning.cu"
    return [{"name": name, "route": "cuda", "source": source, "replaces": None,
             "launches": sum(launches_by_phase[name].values()),
             "launches_by_phase": launches_by_phase[name], "max_abs_err": 0,
             "ms": big[key], "plain_ms": big["plain_static"] if name == "bin_sort" else None,
             "bound_ms": big["bound"], "bound_by": "bytes", "library_ms": None}
            for name, key in (("bin_count", "count"), ("bin_sort", "sort"))]


ADAM_SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3), "scaling": (3,),
               "rotation": (4,), "opacity": (1,)}
ADAM_CAMERA_SHAPES = {"rot": (4,), "trans": (3,)}
# The Gaussians of a state whose sizes are no multiple of 4 (the densify
# cell's N is of this order).
ADAM_ODD_N = 627_001
# Bytes an Adam step moves a float: p, g, m and v read, p, m and v written.
ADAM_BYTES_PER_FLOAT = 28
# Relative norm gap of each p, m and v between the kernel and the plain version.
ADAM_REL_GAP = 1e-6
# A buffer twice the 50 MB L2, written before a timed call to flush it.
L2_FLUSH_BYTES = 2 * 50 * 2 ** 20


def adam_inputs(shapes, n, lrs, seed, dev):
    """(params with gradients, an AdamState at count 20,000, ``lrs``) with
    random values, the moments as after some steps (v > 0); ``n`` rows, or
    the shapes alone where ``n`` is None."""
    from reduced_3dgs_torch.trainer import optimizer
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape, scale):
        return scale * torch.randn(shape, device=dev, generator=gen)

    params = {k: torch.nn.Parameter(rand(tail if n is None else (n, *tail), 1.0))
              for k, tail in shapes.items()}
    for p in params.values():
        p.grad = rand(p.shape, 1e-2)
    state = optimizer.AdamState(count=optimizer.adam_count(20_000, dev),
                                m={k: rand(p.shape, 1e-3) for k, p in params.items()},
                                v={k: rand(p.shape, 1e-3).square() for k, p in params.items()})
    return params, state, lrs


def adam_copy(params, state):
    """Clones of ``params`` (sharing their gradients) and of ``state``."""
    from reduced_3dgs_torch.trainer import optimizer
    ref = {k: torch.nn.Parameter(p.detach().clone()) for k, p in params.items()}
    for k, p in ref.items():
        p.grad = params[k].grad
    return ref, optimizer.AdamState(count=state.count.clone(),
                                    m={k: t.clone() for k, t in state.m.items()},
                                    v={k: t.clone() for k, t in state.v.items()})


def adam_gaps(update, params, state, lrs):
    """One step of ``update`` on clones of ``params`` and ``state`` against
    one of the plain version on others: {"<name>.<p|m|v>": relative norm
    gap}."""
    from reduced_3dgs_torch.trainer import optimizer
    (a, a_state), (b, b_state) = adam_copy(params, state), adam_copy(params, state)
    update(a, a_state, lrs)
    optimizer.adam_plain(b, b_state, lrs)
    return {f"{k}.{which}": float((x.detach() - y.detach()).norm() / y.detach().norm())
            for k in params
            for which, x, y in (("p", a[k], b[k]), ("m", a_state.m[k], b_state.m[k]),
                                ("v", a_state.v[k], b_state.v[k]))}


def library_adam(params, state, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """``adam_update``'s step by PyTorch's fused multi-tensor Adam
    (``torch._fused_adam_``, what ``torch.optim.Adam(fused=True)`` calls),
    one call a learning rate, on float step counts kept beside ``state``
    (advanced by one ``_foreach_add_``, as torch.optim.Adam does). Returns
    the step function."""
    names = list(params)
    steps = [state.count.to(torch.float32).clone() for _ in names]
    groups = {}
    for name, step in zip(names, steps):
        lr = lrs[name]
        key = ("tensor", id(lr)) if isinstance(lr, torch.Tensor) else ("float", lr)
        groups.setdefault(key, (lr, []))[1].append((name, step))

    def step_fn(p=params, st=state):
        torch._foreach_add_(steps, 1)
        for lr, members in groups.values():
            torch._fused_adam_([p[k] for k, _ in members], [p[k].grad for k, _ in members],
                               [st.m[k] for k, _ in members], [st.v[k] for k, _ in members],
                               [], [t for _, t in members], lr=lr, beta1=b1, beta2=b2,
                               weight_decay=0.0, eps=eps, amsgrad=False, maximize=False)
    return step_fn, len(groups)


def adam_phase(card):
    """Phase 19 (see the module docstring). Returns the kernel's record for
    the last line but its launches."""
    from reduced_3dgs_torch.trainer import optimizer
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    n = PREPROCESS_LARGE_N
    gaussian_lrs = {"xyz": torch.tensor(1.6e-6, device=dev), "features_dc": 0.0025,
                    "features_rest": 0.0025 / 20, "scaling": 0.005, "rotation": 0.001,
                    "opacity": 0.05}

    # One step of the kernel against the plain version from the same state:
    # the 16-byte path, the scalar tail and a camera's state.
    gaps = {}
    for what, shapes, rows, lrs in (
            (f"N={n}", ADAM_SHAPES, n, gaussian_lrs),
            (f"N={ADAM_ODD_N}", ADAM_SHAPES, ADAM_ODD_N, gaussian_lrs),
            ("camera", ADAM_CAMERA_SHAPES, None, {"rot": 1e-5, "trans": 1e-3})):
        params, state, lrs = adam_inputs(shapes, rows, lrs, 19, dev)
        gaps[what] = adam_gaps(optimizer.adam_fused, params, state, lrs)
        del params, state
    worst = {what: max(g.values()) for what, g in gaps.items()}
    log(f"phase 19 [{card}]: Adam kernel against the plain version, one step from the same "
        f"state: largest relative norm gap by state {json.dumps(worst)} (bar {ADAM_REL_GAP}); "
        f"by tensor {json.dumps(gaps)}")
    if not max(worst.values()) <= ADAM_REL_GAP:
        raise AssertionError(f"phase 19: the Adam kernel left the plain version: {worst}")

    params, state, lrs = adam_inputs(ADAM_SHAPES, n, gaussian_lrs, 19, dev)
    floats = sum(p.numel() for p in params.values())
    library, library_calls = library_adam(params, state, lrs)
    library_gaps = adam_gaps(lambda p, st, r: library_adam(p, st, r)[0](), params, state, lrs)
    library_gap = max(library_gaps.values())
    flush_buffer = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        flush_buffer.zero_()

    def fused():
        optimizer.adam_fused(params, state, lrs)

    def plain():
        optimizer.adam_plain(params, state, lrs)

    calls = 10
    fused_ms = cuda_ms(fused, setup=flush)
    back_to_back_ms = cuda_ms(lambda: [fused() for _ in range(calls)], repeats=5) / calls
    plain_ms = cuda_ms(plain, setup=flush, repeats=10)
    library_ms = cuda_ms(library, setup=flush, repeats=10)
    library_back_to_back_ms = cuda_ms(lambda: [library() for _ in range(calls)], repeats=5) / calls

    flush_launches, flush_ms = device_busy(flush, calls=5)[:2]

    def profiled(fn):
        """(device kernels a call, device ms a call), the flush's taken off."""
        launched, busy = device_busy(lambda: (flush(), fn()), calls=5)[:2]
        return launched - flush_launches, busy - flush_ms

    _, _, _, top, by_name = device_busy(lambda: (flush(), fused()), calls=calls)
    recorded = sum(count for key, count, _ in top if "adam_kernel" in key)
    device_ms = kernel_device_ms(by_name, "adam_kernel") if recorded == 1 else None
    plain_launches, plain_device_ms = profiled(plain)
    library_launches, library_device_ms = profiled(library)
    nbytes = ADAM_BYTES_PER_FLOAT * floats
    bound = nbytes / DRAM_BYTES_PER_S * 1e3
    # A profile that lost launches reads a fraction of a kernel a call, or
    # less time than the bytes take.
    if library_launches != int(library_launches) or library_device_ms < bound:
        library_text = f"not measured (the profiler kept {library_launches:g} kernels a call)"
        library_device_ms = None
    else:
        library_text = (f"{library_device_ms:.4f} ms ({100 * bound / library_device_ms:.1f}% "
                        f"of the bound)")
    # The profiler has been seen to keep only some of a window's launches of
    # this kernel late in a long run: a reading is kept only when it holds
    # each call's launch.
    device_text = (f"not measured (the profiler kept {recorded} launches a call, of 1)"
                   if device_ms is None else "not measured (the profiler saw no device time)")
    if device_ms:
        device_text = (f"{device_ms:.4f} ms ({100 * bound / device_ms:.1f}% of the bound, "
                       f"{nbytes / (device_ms * 1e-3) / 1e12:.3f} TB/s)")
    log(f"phase 19 [{card}]: Adam over N={n} ({floats} floats, {nbytes / 1e9:.3f} GB at "
        f"{ADAM_BYTES_PER_FLOAT} B a float): kernel step {fused_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch._fused_adam_ ({library_calls} calls a step) "
        f"{library_ms:.4f} ms (CUDA events, the L2 flushed before each call); over {calls} "
        f"steps back to back the kernel {back_to_back_ms:.4f} ms a step "
        f"({100 * bound / back_to_back_ms:.1f}% of the bound), torch._fused_adam_ "
        f"{library_back_to_back_ms:.4f} ({100 * bound / library_back_to_back_ms:.1f}%); "
        f"bound {bound:.4f} ms at "
        f"{DRAM_BYTES_PER_S / 1e12:.2f} TB/s; device time under the profiler, the L2 "
        f"flushed: adam_kernel {device_text}; the plain version's {plain_launches:g} kernels "
        f"{plain_device_ms:.4f} ms; torch._fused_adam_'s {library_launches:g} kernels "
        f"{library_text}; its relative norm gap to the plain version by tensor "
        f"{json.dumps(library_gaps)}")
    del params, state, flush_buffer, library
    torch.cuda.empty_cache()
    log(f"phase 19 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    return {"name": "adam_fused", "route": "cuda",
            "source": "reduced_3dgs_torch/ops/rasterize/csrc/adam.cu", "replaces": None,
            "max_rel_norm_err": max(worst.values()), "ms": fused_ms, "device_ms": device_ms,
            "back_to_back_ms": back_to_back_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms, "library_back_to_back_ms": library_back_to_back_ms,
            "library_device_ms": library_device_ms,
            "library_launches": library_launches, "library_max_rel_norm_err": library_gap}


def card_name():
    from reduced_3dgs_torch.tools.convergence_proof import smi_line
    line = smi_line()
    if line is None:
        raise RuntimeError("nvidia-smi gave no name and power limit")
    return line


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2], sys.argv[3:])
    with tempfile.TemporaryDirectory() as tmp:
        return run(tmp)


def run(tmp):
    from reduced_3dgs_torch import render
    from reduced_3dgs_torch.dataset.camera import build_camera
    from reduced_3dgs_torch.dataset.dataset import CameraDataset, prepare_dataset
    from reduced_3dgs_torch.ops.rasterize import _build, common, tiled
    from reduced_3dgs_torch.importance import BaseImportancePruningTrainer, prune_gaussians
    from reduced_3dgs_torch.ops.rasterize.composite import (CompositeSorted, composite_bwd,
                                                            composite_bwd_plain, composite_fwd,
                                                            composite_fwd_plain,
                                                            composite_fwd_stats,
                                                            composite_fwd_stats_plain,
                                                            pack_fields)
    from reduced_3dgs_torch.shculling import (SHCullingTrainerWrapper, VariableSHGaussianModel,
                                              cull_sh_bands)
    from reduced_3dgs_torch.train import training
    from reduced_3dgs_torch.trainer import Trainer

    dev = torch.device("cuda")
    wrappers = {"composite_fwd": composite_fwd, "composite_fwd_stats": composite_fwd_stats,
                "composite_bwd": composite_bwd}
    # Phases 6, 11, 14, 15 and 16 count the preprocess and binning kernels too.
    all_wrappers = with_preprocess(wrappers)
    # Phases 0-14 step one camera a call (their checks wrap trainer.step);
    # the subprocesses of phases 10-13 inherit it.
    os.environ["R3DGS_WINDOW"] = "1"
    t_start = time.perf_counter()
    # ---------------------------------------------------------------- phase 0
    card = card_name()
    log(card)
    log(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- phase 1
    t0 = time.perf_counter()
    _build.build_libraries(_build.SOURCES)
    for name in _build.SOURCES:
        _build.load_library(name)
    log(f"phase 1: built and loaded {list(_build.SOURCES)} (launchers "
        f"{sorted(_build.ARGTYPES)}) in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for kernel, u in sorted(_build.resource_usage(name).items()):
            ident = f", {KERNEL_IDS[kernel]}" if kernel in KERNEL_IDS else ""
            log(f"phase 1: {kernel} ({name}.cu{ident}): {u['registers']} registers, "
                f"{u['smem_bytes']} B static shared memory, spill stores "
                f"{u['spill_stores']} B, spill loads {u['spill_loads']} B, stack "
                f"{u['stack_bytes']} B")

    # ---------------------------------------------------------------- phase 2
    params = bench_scene(0)
    params_p = perturbed(params)
    model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    model_p = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    poses = view_poses()
    cameras = [view_camera(pose, dev) for pose in poses]
    loss_cam = view_camera(poses[0], dev, bg_color=LOSS_BG)
    log(f"phase 2: bench scene N={model.num_points} at {HEIGHT}x{WIDTH}, "
        f"{N_VIEWS} views, SH degree {model.max_sh_degree}; perturbed copy for training")

    # ---------------------------------------------------------------- phase 3
    with torch.no_grad():
        bench = compare_compositor("bench", model, cameras[0])
        per_tile = (bench["inputs"][2] - bench["inputs"][1]).double()
        log(f"phase 3 [bench]: entries per tile over {per_tile.numel()} tiles: mean "
            f"{float(per_tile.mean()):.2f}, p99 {float(per_tile.quantile(0.99)):.2f}, max "
            f"{int(per_tile.max())}")
        opaque_params = dict(params, opacity=np.full_like(params["opacity"], 8.0))
        opaque_model = VariableSHGaussianModel(3, device=dev).load_numpy(opaque_params)
        opaque = compare_compositor("opaque", opaque_model, cameras[0])
        if opaque["latched"] == 0:
            raise AssertionError("opaque scene: no pixel latched")
        culled_params = dict(params, xyz=params["xyz"] * np.float32(-1.0))
        culled = compare_compositor(
            "culled", VariableSHGaussianModel(3, device=dev).load_numpy(culled_params),
            cameras[0])
        if culled["k"] != 0 or culled["empty"] != culled["tiles"]:
            raise AssertionError("culled scene: expected every tile empty")
        stats_bench = compare_stats("bench", bench)
        stats_opaque = compare_stats("opaque", opaque)
        stats_culled = compare_stats("culled", culled)
        if stats_culled["per_gaussian"].abs().max() != 0:
            raise AssertionError("culled scene: expected all-zero statistics")
        log(f"phase 3 [culled]: per-Gaussian statistics all zero over {culled['n']} Gaussians")
        stats_max_abs_err = max(c["max_abs_err"] for c in (stats_bench, stats_opaque,
                                                          stats_culled))
        del stats_opaque, stats_culled

        gt_loss = torch.clamp(model(loss_cam)["render"], 0, 1)
        real = loss_cotangents(model_p, loss_cam, gt_loss)
        if not real["g_t"].abs().max() > 0:
            raise AssertionError("the loss cotangent of final_T is zero")
        gen = torch.Generator(device=dev).manual_seed(11)

        def random_cotangents(case):
            t = case["inputs"][1].numel()
            return (torch.randn((t, 256, 4), device=dev, generator=gen),
                    torch.randn((t, 256, 1), device=dev, generator=gen))

        bwd_real = compare_backward("bench, loss cotangents", real, real["g_color4"],
                                    real["g_t"])
        bwd_rand = compare_backward("bench, random cotangents", bench,
                                    *random_cotangents(bench))
        bwd_opaque = compare_backward("opaque, random cotangents", opaque,
                                      *random_cotangents(opaque))
        bwd_culled = compare_backward("culled, random cotangents", culled,
                                      *random_cotangents(culled))
        if bwd_culled["grads"].numel() != 0:
            raise AssertionError("culled scene: expected no entries")
        culled_dfields = torch.zeros((10, culled["n"]), device=dev).index_add_(
            1, culled["s_gidx"], bwd_culled["grads"])
        if culled_dfields.abs().max() != 0 or bwd_culled["per_gaussian"].abs().max() != 0:
            raise AssertionError("culled scene: expected all-zero gradients")
        log(f"phase 3 [culled]: per-Gaussian gradients all zero over {culled['n']} Gaussians")
        bwd_max_abs_err = max(b["max_abs_err"] for b in (bwd_real, bwd_rand, bwd_opaque,
                                                          bwd_culled))
        del bwd_rand, bwd_opaque, bwd_culled, opaque_model
    check_ssim_gradient(torch.clamp(model_p(loss_cam)["render"].detach(), 0, 1), gt_loss)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 4
    src, dst = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
    write_dataset(model, src, dst, cameras, poses)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    render.main(["-s", src, "-d", dst, "-i", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    render_launches = {name: fn.launches for name, fn in wrappers.items()}
    with open(os.path.join(dst, "metrics.json")) as f:
        metrics = json.load(f)
    psnrs = [m["psnr"] for m in metrics["per_image"]]
    log(f"phase 4: render.main on {len(psnrs)} views in {wall:.2f} s; psnr {psnrs} "
        f"ssim {[m['ssim'] for m in metrics['per_image']]} "
        f"n_points {metrics['summary']['n_points']} launches {render_launches}")
    if len(psnrs) != N_VIEWS or min(psnrs) < MIN_PSNR_DB or not all(map(math.isfinite, psnrs)):
        raise AssertionError(f"render CLI PSNR below {MIN_PSNR_DB} dB: {psnrs}")
    if metrics["summary"]["n_points"] != N_GAUSSIANS:
        raise AssertionError(f"n_points {metrics['summary']['n_points']}")
    if render_launches != {"composite_fwd": N_VIEWS, "composite_fwd_stats": 0,
                           "composite_bwd": 0}:
        raise AssertionError(f"render path launched {render_launches}, expected "
                             f"{N_VIEWS} forward and no backward compositor")

    # ---------------------------------------------------------------- phase 5
    e, rs, re, tiles_x = bench["inputs"]
    kernel_ms = cuda_ms(lambda: composite_fwd(e, rs, re, tiles_x))
    plain_ms = cuda_ms(lambda: composite_fwd_plain(e, rs, re, tiles_x))
    kernel_ms_2 = cuda_ms(lambda: composite_fwd(e, rs, re, tiles_x))
    latch, start, end = bench["latch"][..., 0].long(), rs.long()[:, None], re.long()[:, None]
    scanned = int((torch.minimum(latch + 1, end) - start).clamp(min=0).sum())
    n_bytes = e.numel() * 4 + 2 * rs.numel() * 4 + rs.numel() * 256 * (16 + 4 + 4)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = scanned * OPS_PER_SCANNED_PAIR / PEAK_F32_OPS_PER_S * 1e3
    fwd_bound = max(bytes_ms, ops_ms)
    fwd_bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"phase 5 [{card}]: composite_fwd kernel {kernel_ms:.4f} ms (again {kernel_ms_2:.4f}), "
        f"plain {plain_ms:.4f} ms, K={bench['k']}, scanned pairs {scanned}, "
        f"bytes {n_bytes}, bound {fwd_bound:.4f} ms "
        f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); share of the bound "
        f"{fwd_bound / kernel_ms:.4f}")

    r_e, r_rs, r_re, r_tx = real["inputs"]
    bwd_args = (r_e, r_rs, r_re, r_tx, real["final_t"], real["latch"], real["g_color4"],
                real["g_t"])
    bwd_ms = cuda_ms(lambda: composite_bwd(*bwd_args))
    bwd_plain_ms = cuda_ms(lambda: composite_bwd_plain(*bwd_args))
    bwd_ms_2 = cuda_ms(lambda: composite_bwd(*bwd_args))
    bwd_pairs, bwd_contrib = backward_pairs(r_e, r_rs, r_re, r_tx, real["latch"])
    t_tiles = r_rs.numel()
    # e read and the gradients written (40 B per entry each), the ranges, and
    # per pixel final_T, latch, g_color4 and g_T (28 B).
    bwd_bytes = 2 * r_e.numel() * 4 + 2 * t_tiles * 4 + t_tiles * 256 * (4 + 4 + 16 + 4)
    bwd_bytes_ms = bwd_bytes / PEAK_BYTES_PER_S * 1e3
    bwd_ops = bwd_pairs * OPS_PER_SCANNED_PAIR + bwd_contrib * OPS_PER_CONTRIBUTING_PAIR
    bwd_ops_ms = bwd_ops / PEAK_F32_OPS_PER_S * 1e3
    bwd_bound = max(bwd_bytes_ms, bwd_ops_ms)
    bwd_bound_by = "bytes" if bwd_bytes_ms >= bwd_ops_ms else "operations"
    log(f"phase 5 [{card}]: composite_bwd kernel {bwd_ms:.4f} ms (again {bwd_ms_2:.4f}), "
        f"plain {bwd_plain_ms:.4f} ms, K={real['k']}, pairs before the latch {bwd_pairs}, "
        f"of them contributing {bwd_contrib}, operations {bwd_ops}, bytes {bwd_bytes}, bound {bwd_bound:.4f} ms "
        f"(bytes {bwd_bytes_ms:.4f}, operations {bwd_ops_ms:.4f}); share of the bound "
        f"{bwd_bound / bwd_ms:.4f}")
    del bwd_args

    # The statistics compositor at the bench scene, camera 0, beside B1 again.
    stats_ms = cuda_ms(lambda: composite_fwd_stats(e, rs, re, tiles_x))
    stats_plain_ms = cuda_ms(lambda: composite_fwd_stats_plain(e, rs, re, tiles_x))
    stats_ms_2 = cuda_ms(lambda: composite_fwd_stats(e, rs, re, tiles_x))
    kernel_ms_3 = cuda_ms(lambda: composite_fwd(e, rs, re, tiles_x))
    stats_contrib = stats_bench["contributing"]
    # B1's bytes and 16 B per entry of statistics written.
    stats_bytes = n_bytes + 4 * e.shape[1] * 4
    stats_bytes_ms = stats_bytes / PEAK_BYTES_PER_S * 1e3
    stats_ops = scanned * OPS_PER_SCANNED_PAIR + stats_contrib * OPS_PER_STATS_CONTRIBUTING_PAIR
    stats_ops_ms = stats_ops / PEAK_F32_OPS_PER_S * 1e3
    stats_bound = max(stats_bytes_ms, stats_ops_ms)
    stats_bound_by = "bytes" if stats_bytes_ms >= stats_ops_ms else "operations"
    log(f"phase 5 [{card}]: composite_fwd_stats kernel {stats_ms:.4f} ms (again "
        f"{stats_ms_2:.4f}), plain {stats_plain_ms:.4f} ms, composite_fwd again "
        f"{kernel_ms_3:.4f} ms; K={bench['k']}, scanned pairs {scanned}, of them contributing "
        f"{stats_contrib}, operations {stats_ops}, bytes {stats_bytes}, bound "
        f"{stats_bound:.4f} ms (bytes {stats_bytes_ms:.4f}, operations {stats_ops_ms:.4f}); "
        f"share of the bound {stats_bound / stats_ms:.4f}")
    with torch.no_grad():
        stats_dev = device_busy(lambda: composite_fwd_stats(e, rs, re, tiles_x))[4]
    stats_dev_ms = kernel_device_ms(stats_dev, "composite_fwd_kernel<true>")
    order_dev_ms = kernel_device_ms(stats_dev, "tile_order_kernel")
    if stats_dev_ms > 0:
        log(f"phase 5 [{card}]: composite_fwd_stats device time under torch.profiler "
            f"{stats_dev_ms:.4f} ms (+ {order_dev_ms:.4f} ms of tile order) against "
            f"{stats_ms:.4f} ms by CUDA events; share of the bound by device time "
            f"{stats_bound / stats_dev_ms:.4f}")
    else:
        log("phase 5: composite_fwd_stats device time not measured (the profiler saw no "
            "device time)")

    # The two reduction events over the 4 views at the bench scene: an
    # importance-pruning sweep (4 statistics renders and the scores) and an
    # SH cull (8 statistics renders), each cull from the same starting state.
    views = CameraDataset(cameras)

    def prune():  # ImportancePruner's default type and thresholds
        return prune_gaussians(model, views, prune_type="comprehensive", prune_percent=0.1,
                               prune_thr_v_important_score=3.0, prune_thr_count=1,
                               prune_thr_T_alpha=1, prune_thr_T_alpha_avg=0.001)

    with torch.no_grad():
        prune_ms = cuda_ms(prune)
        n_pruned = int(prune().sum())
        prune_busy = device_busy(prune)
    cull_model = VariableSHGaussianModel(3, device=dev).load_numpy(params)
    start_dc = cull_model._features_dc.detach().clone()
    start_rest = cull_model._features_rest.detach().clone()

    def reset_cull_model():
        with torch.no_grad():
            cull_model._features_dc.copy_(start_dc)
            cull_model._features_rest.copy_(start_rest)
        cull_model.init_degrees()

    def cull():  # SHCuller's default thresholds
        cull_sh_bands(cull_model, views, threshold=6, std_threshold=0.04)

    cull_ms = cuda_ms(cull, setup=reset_cull_model)
    cull_busy = device_busy(lambda: (reset_cull_model(), cull()))
    degree_hist = torch.bincount(cull_model._degrees.long(), minlength=4).tolist()
    log(f"phase 5 [{card}]: prune_gaussians over {len(views)} views {prune_ms:.4f} ms "
        f"(ImportancePruner's defaults: {n_pruned} of {model.num_points} to prune); "
        f"cull_sh_bands over {len(views)} views {cull_ms:.4f} ms (SHCuller's defaults; "
        f"degrees 0-3 after: {degree_hist})")
    print_busy(card, "importance sweep", prune_busy)
    print_busy(card, "SH cull", cull_busy)
    b2_ms = [kernel_device_ms(busy[4], "composite_fwd_kernel<true>")
             for busy in (prune_busy, cull_busy)]
    log(f"phase 5 [{card}]: composite_fwd_stats device time under the profiler per importance "
        f"sweep {b2_ms[0]:.4f} ms, per SH cull {b2_ms[1]:.4f} ms")
    del cull_model, start_dc, start_rest

    stages = {"preprocess": [], "binning_sort": [], "gather_kernel": [], "assembly": []}
    camera = cameras[0]
    with torch.no_grad():
        for it in range(REPEATS + 3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            settings = model.render_settings(camera)
            tx, ty = common.tile_grid(settings)
            pre = common.preprocess(*model.render_array_args(), settings)
            ev[1].record()
            ent = tiled.bin_and_sort(pre.rect_min, pre.rect_max, pre.tiles_touched,
                                     pre.depths, tx, ty)
            ev[2].record()
            color4, final_t = CompositeSorted.apply(
                pack_fields(pre), ent["s_gidx"], ent["range_start"], ent["range_end"], tx)
            ev[3].record()
            out = tiled._assemble_outputs(color4, final_t, pre, settings, tx, ty,
                                          HEIGHT, WIDTH, ent["num_rendered"])
            ev[4].record()
            ev[4].synchronize()
            if it >= 3:
                for i, key in enumerate(stages):
                    stages[key].append(ev[i].elapsed_time(ev[i + 1]))
    split = {k: statistics.median(v) for k, v in stages.items()}
    with torch.no_grad():
        whole_ms = cuda_ms(lambda: model(camera))
    log(f"phase 5 [{card}]: render per image {whole_ms:.4f} ms; stage medians "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    with torch.no_grad():
        print_busy(card, "render", device_busy(lambda: model(camera)))
    if not torch.isfinite(out["render"]).all() or out["render"].shape != (3, HEIGHT, WIDTH):
        raise AssertionError("render output is not a finite [3, H, W] image")

    # One training step at the bench scene: the perturbed model against the
    # unperturbed scene's render at camera 0.
    with torch.no_grad():
        gt0 = torch.clamp(model(camera)["render"], 0, 1)
    step_cam = build_camera(HEIGHT, WIDTH, camera.FoVx, camera.FoVy, R=camera.R, T=camera.T,
                            ground_truth_image=gt0, device=dev)
    step_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    step_trainer = Trainer(step_model, CameraDataset([step_cam]))
    step_model.active_sh_degree = 3
    step_ms = cuda_ms(lambda: step_trainer.step(step_cam))
    step_stages = {"forward_loss": [], "backward": [], "adam_stats": []}
    loss_fn = step_trainer.loss_pure()
    for it in range(REPEATS + 3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        step_trainer.maybe_advance_schedules()
        loss, out_s, offset = step_trainer.forward_loss(loss_fn, step_cam, {})
        ev[1].record()
        loss.backward()
        ev[2].record()
        step_trainer.optimizer_step(out_s, offset)
        step_trainer.curr_step += 1
        ev[3].record()
        ev[3].synchronize()
        if it >= 3:
            for i, key in enumerate(step_stages):
                step_stages[key].append(ev[i].elapsed_time(ev[i + 1]))
    step_split = {k: statistics.median(v) for k, v in step_stages.items()}
    step_busy = device_busy(lambda: step_trainer.step(step_cam))
    b3_share = kernel_device_ms(step_busy[4], "composite_bwd")
    log(f"phase 5 [{card}]: training step {step_ms:.4f} ms (Trainer.step, N={N_GAUSSIANS}, "
        f"{HEIGHT}x{WIDTH}, SH degree 3); stage medians "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in step_split.items())
        + f"; composite_bwd device time per step under the profiler {b3_share:.4f} ms")
    print_busy(card, "training step", step_busy)
    if not math.isfinite(float(loss.detach())):
        raise AssertionError("training step loss is not finite")
    del step_trainer, step_model, out_s, offset, loss
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 6
    dataset = prepare_dataset(src)
    train_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    trainer = Trainer(train_model, dataset)
    train_model.active_sh_degree = 3
    out_dir = os.path.join(tmp, "train")
    for fn in all_wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = training(dataset, train_model, trainer, None, out_dir, iteration=TRAIN_STEPS,
                      save_iterations=[TRAIN_STEPS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in all_wrappers.items()}
    values = torch.stack(losses).cpu().tolist()
    first, last = statistics.mean(values[:4]), statistics.mean(values[-4:])
    log(f"phase 6: training() {TRAIN_STEPS} steps on {len(dataset)} views in {wall:.2f} s; "
        f"losses {values}; mean of the first 4 {first:.6f}, of the last 4 {last:.6f}; "
        f"launches {launches}")
    if len(values) != TRAIN_STEPS or not all(map(math.isfinite, values)):
        raise AssertionError(f"training losses are not all finite: {values}")
    if not last < first:
        raise AssertionError("training did not reduce the loss")
    if launches != preprocess_expected({"composite_fwd": TRAIN_STEPS, "composite_fwd_stats": 0,
                                        "composite_bwd": TRAIN_STEPS}, adam=TRAIN_STEPS):
        raise AssertionError(f"training launched {launches}, expected {TRAIN_STEPS} of the "
                             "forward and backward compositors, preprocess kernels and Adam "
                             "kernel and no statistics compositor")
    saved = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(out_dir, "point_cloud", f"iteration_{TRAIN_STEPS}", "point_cloud.ply"))
    finite = all(bool(torch.isfinite(p).all()) for p in saved.param_dict().values())
    log(f"phase 6: saved PLY holds {saved.num_points} points, finite {finite}; "
        f"cameras.json {os.path.exists(os.path.join(out_dir, 'cameras.json'))}")
    if saved.num_points != N_GAUSSIANS or not finite:
        raise AssertionError("the trained PLY does not load back whole and finite")

    del trainer, train_model, saved
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 7
    red_model = VariableSHGaussianModel(3, device=dev).load_numpy(params_p)
    red_trainer = SHCullingTrainerWrapper(BaseImportancePruningTrainer, red_model, dataset,
                                          **REDUCTION_CONFIG)
    events = []
    take_step = red_trainer.step

    def step_and_watch(camera):
        """A step; around the steps where an event fires, N, the degrees'
        histogram and the row count of every per-Gaussian tensor."""
        fires = red_trainer.curr_step + 1 in PRUNE_STEPS + CULL_STEPS
        if fires:
            n0 = red_model.num_points
            hist0 = torch.bincount(red_model._degrees.long(), minlength=4).tolist()
        out = take_step(camera)
        if fires:
            rows = {f"{g}/{k}": v.shape[0] for g, t in red_trainer.engine.state_trees().items()
                    for k, v in t.items()}
            events.append(dict(step=red_trainer.curr_step, n_before=n0,
                               n_after=red_model.num_points, degrees_before=hist0,
                               degrees_after=torch.bincount(red_model._degrees.long(),
                                                            minlength=4).tolist(),
                               rows=sorted(set(rows.values()))))
        return out

    red_trainer.step = step_and_watch
    red_dir = os.path.join(tmp, "reduction")
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    red_losses = training(dataset, red_model, red_trainer, None, red_dir,
                          iteration=REDUCTION_STEPS, save_iterations=[])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    red_launches = {name: fn.launches for name, fn in wrappers.items()}
    red_b2 = red_launches["composite_fwd_stats"]
    red_values = torch.stack(red_losses).cpu().tolist()
    for ev in events:
        log(f"phase 7: after step {ev['step']}: N {ev['n_before']} -> {ev['n_after']}, "
            f"degrees 0-3 {ev['degrees_before']} -> {ev['degrees_after']}, rows of every "
            f"per-Gaussian tensor {ev['rows']}")
    log(f"phase 7: training() {REDUCTION_STEPS} steps with importance pruning and SH culling "
        f"on {len(dataset)} views in {wall:.2f} s; losses {red_values}; launches {red_launches}")
    expected = {"composite_fwd": REDUCTION_STEPS, "composite_bwd": REDUCTION_STEPS,
                "composite_fwd_stats": len(dataset) * (len(PRUNE_STEPS) + 2 * len(CULL_STEPS))}
    if red_launches != expected:
        raise AssertionError(f"reduction path launched {red_launches}, expected {expected}")
    if [ev["step"] for ev in events] != sorted(PRUNE_STEPS + CULL_STEPS):
        raise AssertionError(f"events fired after steps {[ev['step'] for ev in events]}")
    for ev in events:
        if ev["rows"] != [ev["n_after"]]:
            raise AssertionError(f"step {ev['step']}: per-Gaussian tensors have rows "
                                 f"{ev['rows']}, the model {ev['n_after']}")
        if ev["step"] in PRUNE_STEPS and not ev["n_after"] < ev["n_before"]:
            raise AssertionError(f"step {ev['step']}: the prune did not lower N")
        if ev["step"] in CULL_STEPS and not (sum(ev["degrees_after"][:3])
                                             > sum(ev["degrees_before"][:3])):
            raise AssertionError(f"step {ev['step']}: the cull lowered no degree")
    if len(red_values) != REDUCTION_STEPS or not all(map(math.isfinite, red_values)):
        raise AssertionError(f"reduction losses are not all finite: {red_values}")
    red_saved = VariableSHGaussianModel(3, device=dev).load_ply(
        os.path.join(red_dir, "point_cloud", f"iteration_{REDUCTION_STEPS}", "point_cloud.ply"))
    log(f"phase 7: saved PLY holds {red_saved.num_points} points (model "
        f"{red_model.num_points}, from {N_GAUSSIANS})")
    if red_saved.num_points != red_model.num_points or not red_model.num_points < N_GAUSSIANS:
        raise AssertionError("the reduced PLY does not hold the pruned model")
    del red_trainer, red_model, red_saved
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 8
    _, dense_config = densification_phase(card, model, params_p, src, cameras, wrappers, tmp,
                                          step_ms)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 9
    knn_phase(card, params)
    colmap_init_phase(card, params, tmp)
    mercy_phase(card, params, poses)
    torch.cuda.empty_cache()
    flagship_launches, flagship_ms = flagship_phase(card, params_p, src, wrappers, tmp,
                                                    dense_config)
    log(f"phase 9: flagship launches {flagship_launches}")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 10
    kmeans_phase(card, params)
    quantize_phase(card, params, params_p)
    torch.cuda.empty_cache()
    quantize_cli_phase(card, params_p, src, wrappers, tmp, dense_config)
    torch.cuda.empty_cache()
    checkpoint_phase(card, params_p, src, tmp)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 11
    t0 = time.perf_counter()
    camera_launches = camera_phase(card, params_p, src, all_wrappers, tmp, dense_config,
                                   flagship_ms)
    log(f"phase 11 [{card}]: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 12
    t0 = time.perf_counter()
    twodgs_train_phase(card, params_p, src, wrappers, tmp, dense_config, flagship_ms)
    torch.cuda.empty_cache()
    twodgs_compare_phase(card, params, params_p)
    torch.cuda.empty_cache()
    viewer_phase(card, params, wrappers)
    lpips_phase(card, params_p, src, dst, tmp)
    native_io_phase(card, params, tmp)
    profiling_phase(card, params_p, src, tmp)
    torch.cuda.empty_cache()
    log(f"phase 12 [{card}]: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 13
    t0 = time.perf_counter()
    band_phase(card, params, params_p, cameras[0], loss_cam, gt_loss, wrappers)
    torch.cuda.empty_cache()
    mesh_phase(card, params_p, src, wrappers, tmp, dense_config)
    torch.cuda.empty_cache()
    log(f"phase 13 [{card}]: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 14
    t0 = time.perf_counter()
    convergence_launches, convergence_b2 = convergence_phase(card, all_wrappers, tmp)
    torch.cuda.empty_cache()
    log(f"phase 14 [{card}]: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 15
    window_launches = window_phase(card, params_p, src, all_wrappers, tmp, dense_config)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 16
    flagship_b2 = N_VIEWS * (len(F_IMPORTANCE) + 2 * len(F_CULL))
    b2_runs = {"7": (red_b2, N_VIEWS * (len(PRUNE_STEPS) + 2 * len(CULL_STEPS))),
               "9": (flagship_launches["composite_fwd_stats"], flagship_b2),
               "14": (convergence_launches["composite_fwd_stats"], convergence_b2),
               "15": (window_launches["composite_fwd_stats"], flagship_b2)}
    sweep_launches = sweep_phase(card, params, b2_runs)
    torch.cuda.empty_cache()
    launches_by_phase = {name: {"11": camera_launches[name], "14": convergence_launches[name],
                                "15": window_launches[name], "16": sweep_launches[name]}
                         for name in all_wrappers}

    # ---------------------------------------------------------------- phase 17
    preprocess_records = preprocess_phase(card, launches_by_phase)

    # ---------------------------------------------------------------- phase 18
    binning_records = binning_phase(card, launches_by_phase)

    # ---------------------------------------------------------------- phase 19
    adam_record = dict(adam_phase(card),
                       launches=sum(launches_by_phase["adam_fused"].values()),
                       launches_by_phase=launches_by_phase["adam_fused"])

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_fwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300",
        "launches": sum(launches_by_phase["composite_fwd"].values()),
        "launches_by_phase": launches_by_phase["composite_fwd"],
        "max_abs_err": bench["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "library_ms": None,
    }, {
        "name": "composite_fwd_stats",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_fwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:300",
        "launches": sum(launches_by_phase["composite_fwd_stats"].values()),
        "launches_by_phase": launches_by_phase["composite_fwd_stats"],
        "max_abs_err": stats_max_abs_err,
        "ms": stats_ms,
        "plain_ms": stats_plain_ms,
        "bound_ms": stats_bound,
        "bound_by": stats_bound_by,
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "reduced_3dgs_torch/ops/rasterize/csrc/composite_bwd.cu",
        "replaces": "reduced_3dgs_tpu/ops/rasterize/pallas_kernel.py:502",
        "launches": sum(launches_by_phase["composite_bwd"].values()),
        "launches_by_phase": launches_by_phase["composite_bwd"],
        "max_abs_err": bwd_max_abs_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }] + preprocess_records + binning_records + [adam_record]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
