#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ucsa_neural_rendering_tpu_torch) on
one NVIDIA GPU: the quickest proof that the port builds, renders and trains
there.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --repeat   # build + phase 18 alone
    python3 chip_smoke.py --out DIR  # where chip_smoke.json and the profile
                                     # tables go (default build/chip_smoke)

Phases (any failure exits nonzero; nothing is caught to keep exit code 0):
  1. CUDA present; the card's name and power limit from nvidia-smi; which
     of cv2, PIL, imageio, yaml, pandas and torchvision import on the
     machine (printed, not asserted: the port needs none of them); what
     the machine offers the native loader (native_loader_probe: the
     compiler's jpeglib.h, png.h, zlib.h, -ljpeg, -lpng, -lz; the runtime
     libraries in ldconfig's cache, at ctypes.util.find_library and
     bundled beside cv2 and PIL; libpng's and zlib's versions; the build
     route that follows; recorded, not asserted).
  2. Build the fifteen CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas reports.
  3. Hold each kernel against its plain PyTorch version on the card, at the
     shapes the render and training paths give it (both placement modes,
     det and per-ray random u; each MLP at the training step's, the test
     and predict renders' and the refresh chunk's numbers of points), and
     the row gather at the benchmark's shapes, with the tolerance stated
     beside each check; time them by device time (the profiler's), not
     between CUDA events, which around ~20 µs calls back to back time the
     host. occ_placement is timed at all five path shapes (test and
     predict stage 1 and refine, the step's), importance_resample at all
     three, hash_encode_fwd at all eight density calls (test and predict
     stage 1, both refine passes' coarse and new samples, the step's two;
     bit-equal to its plain version), the K9 training encodes
     hash_encode_sampled (also at a refresh chunk) and hash_encode_face_fwd
     at the step's two calls (bit-equal; the face encode's launch floor, its
     own time at 32 points, beside), mlp_fwd at all fourteen, mlp_bwd
     at the step's four with its kernel and its dW reduction apart,
     hash_encode_bwd's call in its three modes (exact, stochastic, face;
     each bit-equal to the plain version on the CPU, whose index_add_ adds
     in the kernel's order) and by its parts (the sort's kernels, the
     buckets' sums),
     composite_fwd at all six (test and predict
     stage 1 and refine, the shipped step's and the default
     RenderConfig() step's) and composite_bwd at both steps'; the first
     versions' times (before each kernel's redesign) are printed beside
     theirs. The opt-in paths' shapes (check_dense_kernels): on a 16 × 2
     model, stratified_placement at [4096, 256] (det and jittered) and
     [4096, 16] (bit-equal; its launch floor, its own time at [32, 1],
     beside), hash_encode_fwd at 1,048,576 points,
     importance_resample at [4096, 256 + 256], hash_encode_bwd at
     2,097,152 points (stochastic and exact), hash_encode_sampled at a
     refresh chunk and 65,536 probe points, the compositing pair at
     [4096, 512], the MLPs at 1,048,576 and 2,097,152 rows; on the shipped
     model, the probe's occ_placement [4096, 16] and importance_resample
     [4096, 16 + 32], and hash_encode_fwd on the exact refresh's chunk.
     Phase 14 (a, b) runs here too: pack_table and hash_encode_packed_fwd
     (the packed tables, the card's default) against their
     plain versions, bit-equal: pack_table at both budgets and row dtypes
     on the shipped model and at the 16 × 2 dense program's two, fp8's
     overflow values planted; hash_encode_packed_fwd through the render's
     fp8 table (exact mode at both stage 1s, probe mode at the test
     frame's 65,536 points) and the step's bf16 table (exact, probe and
     face modes at its 98,304 and 32,768 points; exact bit-equal to
     hash_encode_fwd too), pack_table's launch floor (one level of 8
     cells) beside. The encodes' and pack_table's sector floors: the
     distinct 32-byte sectors they need at L2_SECTOR_BYTES_PER_S, the
     card's rate from bench/dma_gather.py's L2 probe.
  4. The render path: NeRFTrainer.render_image at full width — Semantic-NeRF
     8 levels × 4 features, 2^19 table, bound 4, 40 classes, seeded random
     weights (table U(-1, 1)) and a seeded 128³ occupancy grid — renders 3
     frames of 240×320 under the test config and 3 under the predict config
     derived from the shipped train budget, each frame packing its table
     anew (fp8 rows, the card's default) and encoding through it. Launch
     counts are zeroed just before and read just after; every kernel of
     the path must have launched (pack_table and hash_encode_packed_fwd,
     never hash_encode_fwd). The same frames rendered through the plain
     versions on the card must agree; they are timed again with only the
     MLP kernels plain.
  5. The training path: a fresh shipped-config model (tcnn table init
     U(-1e-4, 1e-4), lecun MLPs) fits the kernel path's phase-4 test
     renders (rgb, argmax labels, depth) with NeRFTrainer.train_step —
     4096 rays, 24 proposal-placed + 8 importance samples, stochastic table
     gradients, Adam — from an all-ones grid, with update_occupancy every 16
     steps: 32 steps on the kernel path (counts zeroed before, read after,
     the refreshes' apart; every kernel of the path must have launched, the
     MLP forward in the refresh too; a step repacks its table as bf16 rows,
     one pack_table and two hash_encode_packed_fwd a step, and never
     launches hash_encode_fwd), in turns with 32 from the same init and
     generator seed with only the MLP kernels plain and 32 unpacked
     (train_packed_max_entries 0: hash_encode_fwd two a step, no pack;
     step 1's losses bit-equal to the packed step's, its level sums within
     1e-6; the loss falls), then 32 inside plain_versions() (no launch).
     The first step's losses and per-level table-gradient sums must agree,
     and the mean loss of the last 8 kernel-path steps must be below the
     first's. Then 3 steps at the trainer's default RenderConfig() (256 +
     256 samples a ray), on the kernel path in turns with the plain path,
     held to the same step-1 limits. Then 16 shipped steps each of the K9
     training encoders (stochastic_fwd True, "face" and "fine" at the
     card's default, the last two the hybrids through the step's packed
     table, phase 14 (d); and "face" unpacked), on the kernel path in
     turns with the plain path: 2 launches a step of hash_encode_sampled
     (True, no pack), hash_encode_packed_fwd (the hybrids, a pack_table a
     step) or hash_encode_face_fwd ("face" unpacked, no pack) and of no
     other forward encode; step-1 losses within 2e-3 of the plain path's,
     and against the plain table and compositing kernels (the same sample
     positions) the level sums within 5e-4; the loss falls. The profiled
     frame and step report each kernel's device time.
  6. The row-gather benchmark (python -m
     ucsa_neural_rendering_tpu_torch.bench.dma_gather), counts zeroed
     before and read after: ns per row at each row width.
  7. The segmentation net: full-width DeepLabV3-ResNet101, 40 classes,
     seeded init, through SegTrainer (cuDNN convolutions, no hand kernel).
     At batch 1 with TF32 off the card is held to the CPU on the same
     weights: the eval forward (logits within 1e-4 of their largest
     magnitude, labels equal on 0.999 of the pixels), the BN-trick running
     stats (1e-4 relative) and train step 1 with a shared dropout generator
     (loss within 1e-4 relative; the gradient and Adam's update no further
     from an f64 CPU step than twice the CPU's f32 step is, since a fresh
     R101's train-mode step amplifies f32 rounding to per cents of the
     gradient). At batch 4, 240×320 (the reference's pretrain and joint
     batch): 10 Adam steps (lr 1e-4) on one seeded batch with TF32 off and
     on, in turns (the loss must fall), the last step's confusion matrix
     exactly numpy's on its preds, then the eval forward timed both ways in
     turns (median of 12 after cudnn.benchmark's warm-up), the TF32 logits
     held to the f32 ones (TF32_LOGITS_REL, TF32_LABELS), profiles of an
     eval batch and a step each way, a step's peak memory, and the
     convolutions' multiply-adds with the least times at the f32 and TF32
     peaks. TF32 and cudnn.benchmark are set in this phase only.
  8. The joint adaptation step: JointTrainer with a fresh shipped
     Semantic-NeRF (24 + 8 proposal-placed samples, occupancy on) and a
     seeded full-width DeepLabV3-ResNet101 (40 classes, 240×320, Adam at
     lr_seg 1e-5 and lr_nerf 1e-2: cfg/exp/one_step_joint/s00_lr1e-5.yml),
     phase 4's test renders as the new scene: seg_pseudo_labels of 8
     frames, one 16-step nerf_fit_epoch (its refresh included), 4
     joint_steps of 4 new frames, 2 of 1 new + 1 old + 2 cl frames
     (cl_base.yml), one fused_image_step of 4 images and 2 predict_frames.
     A second trainer from the same seeds runs every step inside
     plain_versions(), in turns with the kernel path, from the kernel
     side's state at each of the three comparisons: the new batch's
     rendered labels equal on >= 0.99 of the pixels, step 1's NeRF losses
     within 2e-3 and seg loss within JOINT_SEG_LOSS_REL, the fused step's
     losses within 2e-3 and level sums within 5e-4, predict labels >= 0.99;
     every loss finite, the NeRF loss falls over the epoch. Counts zeroed
     before, read after: every kernel of the path launched, per joint step
     too. Times per step / image / frame, a joint step's peak memory, a
     profiled joint step and the augmentation alone. TF32 on in this phase
     (both sides), cudnn.benchmark off.
  9. One JSON line of per-kernel numbers, then the last line
     {"ok": true, "device": {...}}; printed after phase 18.
 10. One adaptation stage as a user runs it, through the port's CLI
     (scripts/train_joint.main, in this process, on the card; TF32 on for
     the seg net's convolutions, as the CLI sets it): a synthetic room of
     20 frames of 240×320 written by the port's writer (PNG colour), a
     seeded full-width DeepLabV3-R101 saved as the stage's checkpoint,
     cfg/exp/one_step_joint/s00_lr1e-5.yml read by the port's YAML reader
     (val_scenes the room, trainer.profiler on), the environment in a
     temporary directory, 2 NeRF-fit epochs and 1 joint epoch (the
     reference runs 10 + 50). Counts zeroed before, read after: every
     kernel of the path launched. Every logged loss finite, the fit's loss
     falling; the three checkpoints written and last_ckpt bit-equal to the
     state in memory; one PNG a frame in each predict folder, labels in
     1..40; the saved nerf_ckpt re-rendering the predict frames inside
     plain_versions() with the dumped labels (>= 0.99 of the pixels) and
     rgb (within 1 level on >= 0.99); a second call with
     trainer.resume_from_checkpoint and --joint_train_epoch 2 running only
     the last joint epoch. The stage's wall time, the per-phase seconds of
     profile_steps.jsonl, its peak memory and predict ms a frame (PNG dumps
     included) go to chip_smoke.json under "stage".
 11. The multi-step continual-learning protocol as a user runs it, through
     the port's scripts/cl_deeplab (its parse_args, load_exp_and_env, then
     cl_driver.main with the two rooms as the scene order, in this process,
     TF32 on): cfg/exp/multi_step/cl_base.yml (cl.active: true, every
     joint batch carrying ScanNet-25k replay frames), two synthetic rooms
     of 14 frames of 240×320, a 25k tree of 2 × 8 frames at ScanNet-25k's
     968×1296 (one scene's labels as uint16 raw ids behind a tsv with
     gaps) split by the port's create_split script, a seeded R101 as stage
     0's checkpoint; 2 stages of 1 + 1 epochs, then a protocol resume. The
     checks and cuts are in protocol_phase's docstring; each stage's wall
     time, per-phase seconds, peak memory and launches, the host ms of a
     25k replay item and eval_25k's ms a batch go to chip_smoke.json under
     "protocol".
 12. The pretrain → NeRF-only stage → finetune chain as a user runs it,
     through the port's pretrain, train_joint and train_finetune CLIs
     (their main(argv), in this process, TF32 on) at full width: the
     pretrain over cfg/exp/pretrain_scannet_25k_deeplabv3.yml on 18
     ScanNet-25k-sized synthetic frames (2 epochs, then a resumed call to
     3), the NeRF-only stage (--exp_name one_step_nerf_only
     --joint_train_epoch 0) on a room of 20 frames with its seg net from
     the pretrain's best_ckpt, and the finetune over
     cfg/exp/one_step_finetune_nerf/s00_lr1e-5.yml on the stage's renders
     (2 epochs, then 1 with 25k replay). The checks and records are in
     loops_phase's docstring; they go to chip_smoke.json under "loops",
     and the stage's launches into the kernels line as
     launches_nerf_only.
 13. The opt-in paths: (a) the reference-parity stage through the port's
     train_joint CLI (s00_lr1e-5.yml without its renderer block, nerf
     use_occupancy false at 16 × 2 levels: 256 + 256 samples, no grid) on
     a synthetic room of 8 frames, 1 + 1 epochs, the eight path kernels
     launched and the grid's three not, a nerf_ckpt frame and a first
     dense step held to the plain path; (b) probe-placement renders of
     phase 4's model with and without the grid and under early stop, and
     of the stage's trained nerf_ckpt with a grid refreshed from it,
     against plain; (c) one exact-density refresh against plain; (d)
     DeepLabV3-R101 at batch 4 in bf16 against f32, what each computes in
     and a profiled step of each. The checks are in the
     docstrings of dense_stage, probe_renders, exact_refresh and
     seg_bf16; the records go to chip_smoke.json under "dense", and the
     stage's launches into the kernels line as launches_dense. The dense
     stage's renders and steps go through their packed tables (fp8 at
     2^23: 7 of the 16 levels; bf16 at 2^21) like the shipped ones.
 14. The packed paths (K8, K9's hybrids), phase 3 holding the two kernels:
     (c) one shipped step with bf16 train packing against the same step
     unpacked, from deep copies of one trainer: bit-equal throughout, the
     table's gradient and Adam moments too (packed_step's docstring); (d)
     the "fine" and
     "face" hybrids' steps of phase 5; (e) a test frame through the fp8
     packed table against the unpacked frame (label agreement, device ms),
     the unpacked frame held to its plain version as phase 4's; (f) the
     face bench (bench/face_encode.py); (g) phase 8's joint step of 4 new
     frames at the card's packing defaults against both budgets 0, in
     turns (host ms, launches). The records go to chip_smoke.json under
     "packed".
 15. Data parallelism (parallel/mesh.py) at full width: (a) one rank over
     NCCL against mesh=None, in turns with three mesh=None runs from the
     same init: a shipped NeRF step, a seg step of R101 at batch 4 and a
     joint step of 4 new frames (dp_one_rank: step-1 losses and, after the
     steps, every parameter of the four runs bit-equal; ms a step each
     way);
     (b) two ranks sharing this card over gloo (NCCL refuses two ranks on
     one GPU): the port's pretrain CLI under torch.distributed.run, 2
     steps of 2 images a rank, and a joint step of 4 new frames over two
     spawned ranks, each against one rank (dp_two_ranks' checks). No
     multi-GPU run is made: the machine has one card. The records go to
     chip_smoke.json under "dp", and (a)'s launches into the kernels line
     as launches_dp.
 16. The native loader (data/native_loader.py): built here by the route
     phase 1's probe found, a synthetic room's images, labels and depth
     read through it and through data/image_io.py (native_phase's
     checks), host ms a frame each way and load_rgb_batch's; where it
     does not build, the reason is printed and recorded. Under
     "native_loader" in chip_smoke.json.
 17. The synthetic continual-learning quality gate through the port's CLIs
     (gate_phase's checks): (a) scripts/fit_synthetic at its defaults on
     the kernels and inside plain_versions(), the first steps' losses,
     PSNR and semantic accuracy held together; (b) scripts/quality_gate at
     reduced depth (seed 123, 2 scenes of 5 frames, 10 pretrain epochs,
     4 + 1 epochs a stage) over the incumbent accel16x2 and the shipped
     prop32e8x4, each phase in its own process, then the report table and
     gate_decision: the files, the val-mIoU matrices, the decision and
     each stage process's launches; (c) stage 0 of prop32e8x4 again inside
     plain_versions() from the same pretrain checkpoint, its NeRF's test
     mIoU and its new-scene val mIoU against (b)'s. Under
     "gate" in chip_smoke.json, and (a) and (b)'s launches into the
     kernels line as launches_gate.
 18. The training paths repeat bit for bit (repeat_phase's checks), every
     process under torch.use_deterministic_algorithms(True), so an op
     without a deterministic form fails the run: (a) the gate's pretrain
     at phase 17's cut twice in two processes (its checkpoint and every
     logged record bit-equal); (b) a 32-step shipped NeRF fit in each K9
     mode twice (every parameter, gradient and Adam moment); (c) a joint
     step twice and a stage of prop32e8x4 twice in two processes (both
     models, the optimizers, the checkpoints); (d) hash_encode_bwd twice
     in each mode at the step's and the dense step's shapes. Phases 11
     and 12 (the protocol, the pretrain → NeRF-only → finetune chain) run
     under torch.use_deterministic_algorithms(True) too. Under "repeat" in
     chip_smoke.json.

Bounds (bound_ms) are the larger of bytes / 3.35 TB/s and operations / peak
(67 TFLOP/s f32 outside the tensor cores; 989 TFLOP/s for the MLPs' bf16
products on the tensor cores; 495 TFLOP/s TF32 for the segmentation net's
convolutions), from the published H100 SXM figures, with
the bytes and operations each kernel's work needs on this run's inputs
(formulas beside each kernel below). `launches` is the sum over the render,
training, joint, stage, protocol, NeRF-only stage, dense stage, one-rank
data-parallel and quality-gate paths' runs (the gather's: its benchmark's;
the gate's stage processes report theirs);
chip_smoke.json has them apart, and each kernel's launches in one joint
step (launches_joint). The MLP kernels' line sums the four calls of one
training step; chip_smoke.json has every shape.
"""

import argparse
import contextlib
import copy
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

# a render on the card's defaults: its table packed (fp8 rows, once per
# table version) and every density call encoded through it, never by
# hash_encode_fwd
RENDER_KERNELS = ("pack_table", "hash_encode_packed_fwd", "occ_placement",
                  "importance_resample", "composite_fwd", "mlp_fwd")
MLP_KERNELS = ("mlp_fwd", "mlp_bwd")
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, on the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def bound_by(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    return "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / ops_per_s \
        else "operations"


# the first versions' device times, the kernels before their redesign
# (importance_resample and occ_placement: one thread per ray;
# hash_encode_bwd: one thread per (point, level) with F scalar atomics;
# mlp_fwd: 4-warp blocks, 6 an SM, each loading the weights, scalar row
# loads; mlp_bwd: the same blocks with the dW partials in shared memory and
# a one-thread-a-column reduction; hash_encode_fwd: one thread per (point,
# level), a point's levels on neighbouring threads; composite_fwd and
# composite_bwd: a warp per ray whose lane 0 walked the samples;
# hash_encode_sampled: one thread per (point, level); stratified_placement:
# one thread per (ray, sample); pack_table: one thread per cell, its 8
# vertices gathered; hash_encode_packed_fwd: hash_grid::encode_block's warp
# per level, 8 loads a hashed level), measured by this script's phase 3 on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this
# run's; None where that shape was not timed
FIRST_VERSION_MS = {
    ("importance_resample", "test refine"): 0.2438,
    ("importance_resample", "predict refine"): None,
    ("importance_resample", "train step"): None,
    ("hash_encode_bwd", "call"): 0.1103,
    ("occ_placement", "test stage 1"): 0.1063,
    ("occ_placement", "test refine"): 0.1351,
    ("occ_placement", "predict stage 1"): 0.0906,
    ("occ_placement", "predict refine"): 0.1020,
    ("occ_placement", "train step"): 0.3104,
    # mlp_fwd, keyed "<where> <net> <points>"
    ("mlp_fwd", "step sigma 98304"): 0.0250,
    ("mlp_fwd", "step sigma 32768"): 0.0112,
    ("mlp_fwd", "step color 131072"): 0.0416,
    ("mlp_fwd", "step semantics 131072"): 0.0350,
    ("mlp_fwd", "render sigma 65536"): 0.0185,
    ("mlp_fwd", "render color 65536"): 0.0270,
    ("mlp_fwd", "render semantics 65536"): 0.0216,
    ("mlp_fwd", "render sigma 32768"): 0.0108,
    ("mlp_fwd", "render color 32768"): 0.0157,
    ("mlp_fwd", "render semantics 32768"): 0.0124,
    ("mlp_fwd", "render sigma 8192"): 0.0062,
    ("mlp_fwd", "render color 16384"): 0.0105,
    ("mlp_fwd", "render semantics 16384"): 0.0090,
    ("mlp_fwd", "refresh sigma 262144"): 0.0568,
    # mlp_bwd, keyed as mlp_fwd
    ("mlp_bwd", "step sigma 98304"): 0.0686,
    ("mlp_bwd", "step sigma 32768"): 0.0318,
    ("mlp_bwd", "step color 131072"): 0.1457,
    ("mlp_bwd", "step semantics 131072"): 0.0950,
    # hash_encode_fwd, keyed by the density call of the path
    ("hash_encode_fwd", "test stage 1"): 0.0326,
    ("hash_encode_fwd", "test refine coarse"): 0.0186,
    ("hash_encode_fwd", "test refine new"): 0.0176,
    ("hash_encode_fwd", "predict stage 1"): 0.0182,
    ("hash_encode_fwd", "predict refine coarse"): 0.0056,
    ("hash_encode_fwd", "predict refine new"): 0.0054,
    ("hash_encode_fwd", "train step coarse"): 0.0451,
    ("hash_encode_fwd", "train step new"): 0.0185,
    # composite_fwd and composite_bwd, keyed by the path shape
    ("composite_fwd", "test stage 1"): 0.0079,
    ("composite_fwd", "test refine"): 0.0148,
    ("composite_fwd", "predict stage 1"): 0.0052,
    ("composite_fwd", "predict refine"): 0.0079,
    ("composite_fwd", "train step"): 0.0131,
    ("composite_fwd", "default step"): 0.3193,
    ("composite_bwd", "train step"): 0.0202,
    ("composite_bwd", "default step"): 0.3373,
    # hash_encode_sampled: the refresh chunk and the K9 step's two calls
    ("hash_encode_sampled", "refresh"): 0.0280,
    ("hash_encode_sampled", "train step coarse"): 0.0117,
    ("hash_encode_sampled", "train step new"): 0.0051,
    # stratified_placement: the dense chunk, det and jittered, and the probe
    ("stratified_placement", "dense render"): 0.0069,
    ("stratified_placement", "dense step"): 0.0079,
    ("stratified_placement", "probe"): 0.0017,
    # pack_table, keyed "<where> <row dtype>", and hash_encode_packed_fwd,
    # keyed "<where> <mode> <row dtype>"
    ("pack_table", "shipped 8 x 4 bf16"): 0.0451,
    ("pack_table", "shipped 8 x 4 fp8"): 0.0370,
    ("pack_table", "dense 16 x 2 fp8"): 0.1950,
    ("pack_table", "dense 16 x 2 bf16"): 0.0387,
    ("hash_encode_packed_fwd", "test stage 1 exact fp8"): 0.0174,
    ("hash_encode_packed_fwd", "test stage 1 probe fp8"): None,
    ("hash_encode_packed_fwd", "predict stage 1 exact fp8"): 0.0106,
    ("hash_encode_packed_fwd", "train step coarse exact bf16"): 0.0271,
    ("hash_encode_packed_fwd", "train step new exact bf16"): 0.0109,
    ("hash_encode_packed_fwd", "train step coarse probe bf16"): 0.0140,
    ("hash_encode_packed_fwd", "train step new probe bf16"): 0.0056,
    ("hash_encode_packed_fwd", "train step coarse face bf16"): 0.0195,
    ("hash_encode_packed_fwd", "train step new face bf16"): 0.0075,
}


def first_version(*key):
    ms = FIRST_VERSION_MS.get(key)
    return "not measured" if ms is None else f"{ms:.4f} ms"


def first_versions_line():
    """FIRST_VERSION_MS on a line of its own, labelled as what it is:
    constants from earlier runs, not numbers of this one."""
    return ("first versions' ms (constants from earlier PRs' runs of this "
            "script, PERF.md §6; not measured in this run): "
            + json.dumps({f"{name} / {where}": ms for (name, where), ms
                          in FIRST_VERSION_MS.items()}))


def profiles_line():
    """The profiles bench.device_ms took so far and the short ones it took
    again (ROADMAP F6)."""
    from ucsa_neural_rendering_tpu_torch import bench
    return (f"  bench.device_ms: {bench.PROFILES['taken']} profiles, "
            f"{bench.PROFILES['short']} of them short and taken again, "
            f"{bench.PROFILES['recounted']} whose count of a call's "
            f"operations came from its launches")


def placement_work(n, n_cand, s, cells, random_u):
    """(bytes, operations) of occ_placement on n rays of s samples: rays in,
    the per-ray u in where given, z out, each distinct grid cell the
    candidates touch read once; ~40 ops per candidate weight, each computed
    once, ~20 per sample."""
    return (n * 24 + n * s * 4 * (2 if random_u else 1) + cells * 4,
            n * (n_cand * 40 + s * 20))


def check_placement(label, o, d, grid, bound, s, cfg, proposal, u=None,
                    timed=True):
    """occ_placement against its plain version on one path shape: sorted,
    finite, max |Δz| 2e-3 and mean 1e-5 (the inverse CDF: the kernel's warp
    scans sum in another order, and a cdf ulp moves z by ulp·width/pdf; z
    spans up to ~14 scene units). The kernel sorts each ray's z, so with
    random u its row is the plain one sorted, as the plain version returns
    it. Returns the kernel's z and the shape's row (times and bound when
    timed)."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops.aabb import near_far_from_aabb
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import cell_index
    args = (o, d, grid, bound, s, cfg.occ_candidates, cfg.min_near, proposal,
            cfg.occ_floor, cfg.occ_density_threshold, cfg.density_scale, u)
    zk, zp = pl.occ_placement(*args), pl.occ_placement_plain(*args)
    torch.cuda.synchronize()
    err, mean = (zk - zp).abs().max().item(), (zk - zp).abs().mean().item()
    n = o.shape[0]
    what = (f"occ_placement {label} [{n},{s}] "
            f"{'proposal' if proposal else 'binary'}"
            f"{', random u' if u is not None else ''}")
    assert torch.isfinite(zk).all() and err <= 2e-3 and mean <= 1e-5, \
        (what, err, mean)
    assert (zk[:, 1:] >= zk[:, :-1]).all(), what
    row = dict(where=label, rays=n, samples=s, proposal=proposal,
               random_u=u is not None, max_abs_err=err, mean_abs_err=mean)
    if not timed:
        log(f"  {what}: max {err:.3e} mean {mean:.3e}")
        return zk, row
    cand = pl.linspace(0.0, 1.0, cfg.occ_candidates, o.device)
    nears, fars = near_far_from_aabb(o, d, pl._aabb(bound, o.device),
                                     cfg.min_near)
    cz = nears[:, None] + (fars - nears)[:, None] * cand
    cells = torch.unique(cell_index(o[:, None] + d[:, None] * cz[..., None],
                                    bound, grid.shape[0])).numel()
    n_bytes, n_ops = placement_work(n, cfg.occ_candidates, s, cells,
                                    u is not None)
    row.update(grid_cells=cells,
               ms=device_ms(lambda: pl.occ_placement(*args)),
               plain_ms=device_ms(lambda: pl.occ_placement_plain(*args),
                                  iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    log(f"  {what}: max {err:.3e} mean {mean:.3e}; kernel {row['ms']:.4f} ms"
        f" (first version: {first_version('occ_placement', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {cells} grid cells)")
    return zk, row


def resample_work(n, s1, s2):
    """(bytes, operations) of importance_resample on n rays: z, sigma in;
    new z, merged z and the order out, the order at 4 B as JAX's int32
    argsort (the int64 the port writes, for take_along_dim, is its design,
    not the function's); each coarse weight once (~10 ops + exp), ~20 per
    new sample, ~4 per merged sample."""
    m = s1 + s2
    return n * (s1 * 8 + s2 * 4 + m * 8), n * (s1 * 12 + s2 * 20 + m * 4)


def check_resample(label, z, sig, s2, scale, u=None):
    """importance_resample against its plain version on one path shape,
    timed: new z (as a set) and merged z within 2e-3, mean 1e-5 (the scans
    sum in another order: a cdf ulp moves z by ulp·width/pdf, and z spans
    up to ~14 scene units); the order the stable argsort of the kernel's
    own [z, new_z] and, for det u, the plain one on >= 0.98 of rays
    (near-ties may differ). Returns the kernel's outputs and the shape's
    numbers."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    nk, zk, ok = pl.importance_resample(z, sig, s2, scale, u)
    npl, zp, op = pl.importance_resample_plain(z, sig, s2, scale, u)
    torch.cuda.synchronize()
    dz = torch.cat([torch.sort(nk, -1).values - torch.sort(npl, -1).values,
                    zk - zp], -1).abs()
    err, mean = dz.max().item(), dz.mean().item()
    z_all = torch.cat([z, nk], -1)
    assert torch.isfinite(zk).all() and err <= 2e-3 and mean <= 1e-5, \
        (label, err, mean)
    assert torch.equal(ok, torch.sort(z_all, dim=-1, stable=True).indices)
    assert torch.equal(torch.take_along_dim(z_all, ok, -1), zk)
    same = None
    if u is None:
        same = (ok == op).all(dim=-1).float().mean().item()
        assert same >= 0.98, (label, same)
    n, s1 = z.shape
    n_bytes, n_ops = resample_work(n, s1, s2)
    row = dict(where=label, rays=n, s1=s1, s2=s2, max_abs_err=err,
               mean_abs_err=mean, order_equal=same,
               ms=device_ms(lambda: pl.importance_resample(z, sig, s2, scale,
                                                           u)),
               plain_ms=device_ms(lambda: pl.importance_resample_plain(
                   z, sig, s2, scale, u), iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops))
    order = "" if same is None else f", order equal on {same:.4f} of rays"
    log(f"  importance_resample {label} [{n},{s1}]+{s2}: max {err:.3e} mean "
        f"{mean:.3e}{order}; kernel {row['ms']:.4f} ms (first version: "
        f"{first_version('importance_resample', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms")
    return nk, zk, ok, row


def check_encode(label, model, x):
    """hash_encode_fwd on one density call's points x [N, 3] of a path:
    bit-equal to its plain version (both sum the same exact f32 products in
    the same order), timed. Returns the shape's row."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    bound = model.bound
    x01 = ((x + bound) / (2.0 * bound)).contiguous()
    tb = model.encoder.table_bf16()
    spec = model.encoder.spec
    hk = he.hash_encode(tb, x01, spec)
    assert torch.equal(hk, he.hash_encode_plain(tb, x01, spec)), label
    npts, L, F = x01.shape[0], spec.n_levels, spec.n_features
    # distinct table rows, and the L2 sectors the gathers touch: each warp
    # load (32 consecutive points at one level, one corner) counted as its
    # distinct 32-byte sectors
    rows = sectors = 0
    warp_corner = (torch.arange(npts, device=x.device)[:, None] // 32 * 8
                   + torch.arange(8, device=x.device)[None]) << 32
    for lv in range(L):
        idx = he._level_indices(x01, spec.resolutions[lv], spec.sizes[lv],
                                spec.hashed[lv])[0] + spec.offsets[lv]
        rows += torch.unique(idx).numel()
        sectors += torch.unique(warp_corner + idx * F * 2 // 32).numel()
    # points in, features out, each distinct table row read once; per
    # (point, level): 3 frac + 8 corners × (2 weight muls + F multiply-adds
    # + ~6 integer hash ops)
    n_bytes = npts * 12 + npts * L * F * 2 + rows * F * 2
    n_ops = npts * L * (3 + 8 * (2 + 2 * F + 6))
    floor_bytes, floor_ms = sector_floor(x01, spec, 0, 0, "exact")
    row = dict(where=label, points=npts, distinct_rows=rows,
               sector_bytes=32 * sectors, sector_floor_bytes=floor_bytes,
               sector_floor_ms=floor_ms, max_abs_err=0.0,
               ms=device_ms(lambda: he.hash_encode(tb, x01, spec)),
               plain_ms=device_ms(lambda: he.hash_encode_plain(tb, x01, spec),
                                  iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    log(f"  hash_encode_fwd {label} [{npts},3] → [{npts},{L * F}]: bit-equal;"
        f" kernel {row['ms']:.4f} ms (first version: "
        f"{first_version('hash_encode_fwd', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {rows} distinct rows; the warps' loads touch "
        f"{32 * sectors / 1e6:.2f} MB of 32-byte sectors, "
        f"{32 * sectors / row['ms'] / 1e9:.2f} TB/s); sector floor "
        f"{floor_ms:.6f} ms ({floor_bytes / 1e6:.2f} MB)")
    return row


# the card's own L2 sector rate: the L2 probe of bench/dma_gather.py
# (`python -m ucsa_neural_rendering_tpu_torch.bench.dma_gather --l2-probe`,
# also the first part of bench/packed_kernels.py) moves 152.3e9 32-byte
# sectors a second (random unsorted 16-byte rows of an 8 MB table, with the
# indices read and the rows written), the fastest of its gathers inside L2,
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6). The sector
# floors below: the distinct sectors each warp of 32 consecutive points
# needs at each level (bench.packed_kernels.encode_work) at this rate.
L2_SECTOR_BYTES_PER_S = 152.3e9 * 32


def sector_floor(x01, spec, n_packed, row_bytes, mode):
    """(bytes, ms) of an encode's sector floor: encode_work's distinct
    sectors at L2_SECTOR_BYTES_PER_S."""
    from ucsa_neural_rendering_tpu_torch.bench.packed_kernels import \
        encode_work
    n_bytes = 32 * encode_work(x01, spec, n_packed, row_bytes,
                               mode)["sectors"]
    return n_bytes, 1e3 * n_bytes / L2_SECTOR_BYTES_PER_S
SAMPLED_KERNELS = {
    # kernel: (wrapper, plain version, rows read per (point, level),
    #          TPU code it replaces)
    "hash_encode_sampled": ("hash_encode_sampled",
                            "hash_encode_sampled_plain", 1,
                            "ucsa_neural_rendering_tpu/models/"
                            "hash_encoding.py:456"),
    "hash_encode_face_fwd": ("hash_encode_face", "hash_encode_face_plain", 4,
                             "ucsa_neural_rendering_tpu/models/"
                             "hash_encoding.py:587"),
}


def check_sampled_encode(name, label, tb, x01, spec):
    """hash_encode_sampled (a copy of the drawn row) or hash_encode_face_fwd
    (its face's 4 rows blended) on one call's x01 [N, 3]: bit-equal to the
    plain version, timed. Bound: points in, features out, each distinct row
    read once (bytes); the sector floor: sector_floor's (the distinct
    sectors each warp's points read at each level). Returns the shape's
    row."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    wrapper, plain, per, _ = SAMPLED_KERNELS[name]
    fn_k = lambda: getattr(he, wrapper)(tb, x01, spec)
    fn_p = lambda: getattr(he, plain)(tb, x01, spec)
    out = fn_k()
    torch.cuda.synchronize()
    assert torch.equal(out, fn_p()), (name, label)
    npts, L, F = x01.shape[0], spec.n_levels, spec.n_features
    idx = (he.sampled_face_rows(x01, spec)[0] if per == 4
           else he.sampled_corner_indices(x01, spec))
    rows = torch.unique(idx).numel()
    n_bytes = npts * 12 + npts * L * F * 2 + rows * F * 2
    # per (point, level): 3 frac, ~12 for each uniform, then the sampled
    # corner's 8 × 4 weight and cdf ops, or the face's ~10 axis ops and 4 ×
    # (2 weight ops + F multiply-adds); ~12 hash ops a row read
    n_ops = npts * L * (3 + 12 + (32 if per == 1 else 10 + 4 * (2 + 2 * F))
                        + 12 * per)
    floor_bytes, floor_ms = sector_floor(x01, spec, 0, 0,
                                         "face" if per == 4 else "probe")
    row = dict(where=label, points=npts, distinct_rows=rows,
               sector_floor_bytes=floor_bytes, sector_floor_ms=floor_ms,
               max_abs_err=0.0, ms=device_ms(fn_k),
               plain_ms=device_ms(fn_p, iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    first = (f" (first version: {first_version(name, label)})"
             if (name, label) in FIRST_VERSION_MS else "")
    log(f"  {name} {label} [{npts},3] → [{npts},{L * F}]: bit-equal; kernel "
        f"{row['ms']:.4f} ms{first}  plain {row['plain_ms']:.4f} ms  bound "
        f"{row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {rows} distinct rows); sector floor "
        f"{row['sector_floor_ms']:.6f} ms ({floor_bytes / 1e6:.2f} MB)")
    return row


# K8: the render's and the training step's packed tables
# (RenderConfig.packed_max_entries and packed_dtype; train_packed_max_entries
# with bf16 rows), and the TPU code the two kernels replace
RENDER_PACK = (2 ** 23, "fp8")
TRAIN_PACK = (2 ** 21, "bf16")
PACK_REPLACES = "ucsa_neural_rendering_tpu/models/packed_table.py:115"
PACKED_REPLACES = "ucsa_neural_rendering_tpu/models/packed_table.py:130"
# per (point, level) of a packed encode: ~operations its lookup takes, by
# mode, on the unpacked levels (a packed level: 3 frac + 8 × (2 weight +
# 2F) operations)
PACKED_MODE_OPS = {"exact": lambda F: 3 + 8 * (2 + 2 * F + 6),
                   "probe": lambda F: 3 + 12 + 32 + 12,
                   "face": lambda F: 3 + 12 + 10 + 4 * (2 + 2 * F) + 48}


def check_packed_encode(rec, label, model, x01, packed, mode):
    """hash_encode_packed_fwd in `mode` through `packed` (the model's
    packed table) on one call's x01 [N, 3]: bit-equal to its plain version
    and, with bf16 rows in exact mode, to hash_encode_fwd; timed. Bound:
    points in, features out, each distinct packed row and table row read
    once (bytes); the sector floor: sector_floor's (the distinct sectors
    each warp's points read at each level). The row goes to
    rec["hash_encode_packed_fwd"]["shapes"]."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.models import packed_table as pt
    spec, tb = model.encoder.spec, model.encoder.table_bf16()
    rows_of = "fp8" if packed.data.element_size() == 1 else "bf16"
    fn_k = lambda: pt.hash_encode_packed(tb, packed, x01, spec, mode)
    fn_p = lambda: pt.hash_encode_packed_plain(tb, packed, x01, spec, mode)
    out = fn_k()
    torch.cuda.synchronize()
    assert torch.equal(out, fn_p()), (label, rows_of, mode)
    equal_fwd = None
    if mode == "exact" and rows_of == "bf16":
        equal_fwd = torch.equal(out, he.hash_encode(tb, x01, spec))
        assert equal_fwd, label
    npts, L, F, k = x01.shape[0], spec.n_levels, spec.n_features, \
        packed.n_packed
    row_bytes = 8 * F * packed.data.element_size()
    ops_a_level = PACKED_MODE_OPS[mode]
    if mode == "exact":
        fine = torch.cat([he._level_indices(
            x01, spec.resolutions[lv], spec.sizes[lv], spec.hashed[lv])[0]
            + spec.offsets[lv] for lv in range(k, L)], 1) if k < L else None
    elif mode == "probe":
        fine = he.sampled_corner_indices(x01, spec, range(k, L)) \
            if k < L else None
    else:
        fine = he.sampled_face_rows(x01, spec)[0][:, k:]
    n_bytes = (npts * 12 + npts * L * F * 2
               + torch.unique(pt.packed_cell_rows(x01, spec, k)).numel()
               * row_bytes
               + (0 if fine is None else torch.unique(fine).numel() * F * 2))
    n_ops = npts * (k * (3 + 8 * (2 + 2 * F)) + (L - k) * ops_a_level(F))
    floor_bytes, floor_ms = sector_floor(x01, spec, k, row_bytes, mode)
    row = dict(where=label, mode=mode, row_dtype=rows_of, points=npts,
               n_packed=k, equal_to_hash_encode_fwd=equal_fwd,
               sector_floor_bytes=floor_bytes, sector_floor_ms=floor_ms,
               max_abs_err=0.0, ms=device_ms(fn_k),
               plain_ms=device_ms(fn_p, iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    first = first_version("hash_encode_packed_fwd",
                          f"{label} {mode} {rows_of}")
    log(f"  hash_encode_packed_fwd {mode} {label} [{npts},3], {k} levels "
        f"packed as {rows_of}: bit-equal"
        f"{' (and to hash_encode_fwd)' if equal_fwd else ''}; kernel "
        f"{row['ms']:.4f} ms (first version: {first})  plain "
        f"{row['plain_ms']:.4f} ms  bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}); sector floor "
        f"{row['sector_floor_ms']:.6f} ms ({floor_bytes / 1e6:.2f} MB)")
    rec.setdefault("hash_encode_packed_fwd", dict(
        name="hash_encode_packed_fwd", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/"
               "hash_encode_packed_fwd.cu",
        replaces=PACKED_REPLACES, library_ms=None, shapes=[]))
    rec["hash_encode_packed_fwd"]["shapes"].append(row)


def check_pack_table(rec, label, model, pack):
    """pack_table on the model's table (fp8's edge values planted) at pack
    = (budget, row dtype): bit-equal to its plain version (NaN rows by
    their bits), timed. Bound: the rows written and each distinct vertex
    row read once (bytes). The row goes to rec["pack_table"]["shapes"]."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.bench.packed_kernels import (
        fp8_edges, pack_work)
    from ucsa_neural_rendering_tpu_torch.models import packed_table as pt
    spec = model.encoder.spec
    table = fp8_edges(model.encoder.table.detach())
    k = pt.choose_n_packed(spec, pack[0])
    fn_k = lambda: pt.build_packed_table(table, spec, k, pack[1])
    fn_p = lambda: pt.build_packed_table_plain(table, spec, k, pack[1])
    out, ref = fn_k().data, fn_p().data
    torch.cuda.synchronize()
    bits = (lambda d: d.view(torch.uint8) if d.element_size() == 1
            else d.view(torch.int16))
    assert torch.equal(bits(out), bits(ref)), (label, pack)
    nan_rows = torch.isnan(out.float()).any(-1).sum().item()
    assert (nan_rows > 0) == (pack[1] == "fp8"), (label, pack, nan_rows)
    # the rows written and each distinct vertex row read once; the sector
    # floor: the written rows' sectors and the distinct sectors of the
    # vertex rows
    work = pack_work(table, spec, k, out.shape[1] * out.element_size())
    rows = out.shape[0]
    # per cell: its level and cell coordinates (~12), 8 vertex indices
    # (~8 each), 8·F conversions (~10 each)
    n_ops = rows * (12 + 8 * 8 + 8 * spec.n_features * 10)
    row = dict(where=label, budget=pack[0], row_dtype=pack[1], n_packed=k,
               rows=rows, mb_written=work["mb_written"],
               mb_vertices=work["mb_vertices"],
               sector_floor_bytes=32 * work["sectors"],
               sector_floor_ms=1e3 * 32 * work["sectors"]
               / L2_SECTOR_BYTES_PER_S,
               nan_rows=nan_rows, max_abs_err=0.0, ms=device_ms(fn_k),
               plain_ms=device_ms(fn_p, iters=3, warmup=1),
               bound_ms=bound_ms(work["bytes"], n_ops),
               bound_by=bound_by(work["bytes"], n_ops))
    log(f"  pack_table {label}: {k} levels, {rows} rows of {pack[1]} at "
        f"{pack[0]} ({row['mb_written']:.1f} MB from "
        f"{row['mb_vertices']:.1f} MB of vertices; {nan_rows} rows with "
        f"fp8 NaN): bit-equal; kernel {row['ms']:.4f} ms (first version: "
        f"{first_version('pack_table', f'{label} {pack[1]}')})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); sector floor {row['sector_floor_ms']:.4f} ms")
    rec.setdefault("pack_table", dict(
        name="pack_table", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/pack_table.cu",
        replaces=PACK_REPLACES, library_ms=None, shapes=[]))
    rec["pack_table"]["shapes"].append(row)


def finish_record(entry, head):
    """A shapes record's head numbers from its row `head`."""
    entry.update(max_abs_err=max(r["max_abs_err"] for r in entry["shapes"]),
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"])


def shapes_record(name, rows, head, replaces):
    """A kernel's record: the head shape's numbers, every shape's row under
    `shapes`."""
    return dict(name=name, route="cuda",
                source=f"ucsa_neural_rendering_tpu_torch/csrc/{name}.cu",
                replaces=replaces,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, shapes=rows)


def composite_work(n, t, c, backward):
    """(bytes, operations) of composite_fwd or composite_bwd on n rays of t
    samples, C = c. Forward: z, sigma, rgb, semantics and norms in; image,
    semantics and depth out; per sample ~8 operations for the weight, 2 per
    output channel. Backward: z, sigma, rgb, norms and cotangents in; d
    sigma, d rgb and d sem out (the semantics themselves are not needed);
    per sample ~30 for the weight, its backward scan and dw, one product
    per d rgb and d sem element."""
    if backward:
        return (n * t * (8 + 12) + n * 4 * (1 + 3 + c + 1)
                + n * t * 4 * (1 + 3 + c), n * t * (30 + 3 + c))
    return (n * (t * (8 + 12 + 4 * c) + 4 + (3 + c + 1) * 4),
            n * t * (8 + 2 * (3 + c + 1)))


def composite_inputs(model, o, d, z, dn, cfg):
    """composite_fwd's arguments on the samples z [N, T] of the rays o, d:
    the model's sigma, rgb and semantics there, as the paths hand them
    over, and the config's density scale and mask threshold."""
    from ucsa_neural_rendering_tpu_torch.ops.renderer import _points
    n, t = z.shape
    sigma, geo = model.density(_points(o, d, z, model.bound))
    dirs = d[:, None, :].expand(n, t, 3).reshape(-1, 3)
    rgb = model.color(dirs, geo).reshape(n, t, 3)
    sem = model.semantics(geo).reshape(n, t, -1)
    return (z, sigma.reshape(n, t).contiguous(), rgb.contiguous(),
            sem.contiguous(), dn.contiguous(), cfg.density_scale,
            cfg.weight_mask_threshold)


def check_composite(label, args, cots=None):
    """composite_fwd (cots None) or composite_bwd (cots: the cotangents of
    image, semantics and depth) against its plain version on one path
    shape, timed; args as composite_inputs gives them. Forward: f32 sums
    over T in another order (and the w > 1e-4 mask at equal weights): 1e-5
    on rgb and semantics mass, 1e-4 on depth (z up to ~14). Backward: d
    sigma, suffix sums against autograd's division through cumprod, within
    rtol 1e-3 and an atol of 1e-4 of the ray's largest |d sigma| short of
    its last sample (δ = 1e10 there); d rgb and d sem, the same weights
    times the cotangent, 1e-5. Returns the shape's row."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    name = "composite_bwd" if cots else "composite_fwd"
    fn_k, fn_p = getattr(cp, name), getattr(cp, f"{name}_plain")
    full = (*args[:5], *(cots or ()), *args[5:])
    outk, outp = fn_k(*full), fn_p(*full)
    torch.cuda.synchronize()
    assert all(torch.isfinite(a).all() for a in outk), label
    errs = [(a - b).abs().max().item() for a, b in zip(outk, outp)]
    if cots:
        ray_scale = outp[0][:, :-1].abs().amax(-1, keepdim=True)
        assert ((outk[0] - outp[0]).abs() <= 1e-3 * outp[0].abs()
                + 1e-4 * ray_scale).all(), label
        assert errs[1] <= 1e-5 and errs[2] <= 1e-5, (label, errs)
    else:
        assert errs[0] <= 1e-5 and errs[1] <= 1e-5 and errs[2] <= 1e-4, \
            (label, errs)
    n, t = args[0].shape
    c = args[3].shape[-1]
    n_bytes, n_ops = composite_work(n, t, c, bool(cots))
    row = dict(where=label, rays=n, samples=t, classes=c,
               max_abs_err=max(errs), errs=errs,
               ms=device_ms(lambda: fn_k(*full)),
               plain_ms=device_ms(lambda: fn_p(*full), iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    log(f"  {name} {label} [{n},{t}] C={c}: max_abs_err "
        f"{' / '.join(f'{e:.3e}' for e in errs)}; kernel {row['ms']:.4f} ms "
        f"(first version: {first_version(name, label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']})")
    return row


def composite_record(name, rows, head):
    """The record of composite_fwd or composite_bwd."""
    return shapes_record(name, rows, head,
                         "ucsa_neural_rendering_tpu/ops/compositing.py:16")


# --------------------------------------------------------------------- scene
def look_at(pos, target=(0.0, 0.0, 0.0)):
    """c2w [4,4] whose camera z axis looks from pos at target (x right,
    y down in the image, as get_rays' pixel directions)."""
    import numpy as np
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, pos
    return pose


POSES = [(0.0, 0.3, -3.0), (2.2, -0.4, -2.0), (-2.0, 0.6, 2.5)]
INTRINSICS = (277.0, 277.0, 160.0, 120.0)  # fx, fy, cx, cy at 240×320


def make_scene(device, seed=0, n_levels=8, n_features=4, log2=19, bound=4.0,
               classes=40, grid_res=128, sigma_scale=24.0):
    """Seeded full-width model and occupancy grid. The table is U(-1, 1),
    level l scaled by 2^-l so that, as in a fitted scene, the fine levels
    carry detail and not the bulk of the field (a field that is white noise
    at the finest cell would turn f32 rounding of the sample positions into
    different renders). The density output's weights are made non-positive
    and 24× wider, so that most of the volume is near-empty as in a fitted
    scene and, in both render configs, more rays stay unsaturated after
    stage 1 than early stop may refine (its top-K cut binds)."""
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    gen = torch.Generator().manual_seed(seed)
    model = SemanticNeRF(bound=bound, num_semantic_classes=classes,
                         n_levels=n_levels, n_features=n_features,
                         log2_hashmap_size=log2, device=device,
                         generator=gen, table_init_range=1.0)
    spec = model.encoder.spec
    with torch.no_grad():
        for lvl in range(spec.n_levels):
            a = spec.offsets[lvl]
            model.encoder.table[a:a + spec.sizes[lvl]] *= 0.5 ** lvl
        w = model.sigma_net.layers[-1].weight
        w[0] = -sigma_scale * w[0].abs()
    r = grid_res
    occupied = torch.rand((r, r, r), generator=gen) > 0.5
    grid = torch.where(occupied, 20.0 * torch.rand((r, r, r), generator=gen),
                       torch.full((r, r, r), 1e-3)).to(device)
    return model, grid


def render_configs():
    """The JointTrainer's derived full-frame configs for the shipped train
    budget (JAX package train/joint_trainer.py:96-136): proposal training
    at 24+8 → test 32+32 with early stop (stage 1: 16, top 1/4 refined,
    binary placement) → predict es8→16+16, top 1/8."""
    from ucsa_neural_rendering_tpu_torch.config import SHIPPED_TRAIN_BUDGET
    from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
    total = sum(SHIPPED_TRAIN_BUDGET)
    test = RenderConfig(num_steps=total, upsample_steps=total,
                        early_stop=True,
                        stage1_steps=max(1, min(16, total // 2)),
                        refine_fraction=0.25, proposal_placement=False,
                        max_ray_batch=4096)
    predict = replace(test, stage1_steps=max(1, test.stage1_steps // 2),
                      num_steps=max(1, test.num_steps // 2),
                      upsample_steps=max(1, test.upsample_steps // 2),
                      refine_fraction=0.125)
    return {"test": test, "predict": predict}


# ------------------------------------------------------------- kernel checks
def recorder(rec):
    """record(name, err, fn_k, fn_p, n_bytes, n_ops, replaces, source,
    extra="", fn_lib=None): time kernel, plain version and, where one
    PyTorch call computes the same function, that call; put the numbers in
    rec[name]."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms

    def record(name, err, fn_k, fn_p, n_bytes, n_ops, replaces, source,
               extra="", fn_lib=None):
        ms = device_ms(fn_k)
        plain_ms = device_ms(fn_p, iters=5, warmup=1)
        lib_ms = device_ms(fn_lib) if fn_lib else None
        rec[name] = dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=float(err), ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms(n_bytes, n_ops),
                         bound_by=bound_by(n_bytes, n_ops), library_ms=lib_ms)
        lib = f"library {lib_ms:.4f} ms  " if fn_lib else ""
        log(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  {lib}bound {rec[name]['bound_ms']:.4f} ms "
            f"({rec[name]['bound_by']}) {extra}")
    return record


def check_kernels(model, grid, cfgs, device):
    """Phase 3: each kernel against its plain version at the render path's
    shapes; returns {name: record} with error, times and bound."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops.renderer import _points

    test = cfgs["test"]
    chunk = test.max_ray_batch
    k_refine = int(round(chunk * test.refine_fraction))
    rays = get_rays(look_at(POSES[0]), INTRINSICS, 240, 320, device=device)
    o = rays["rays_o"][:chunk].contiguous()
    d = rays["rays_d"][:chunk].contiguous()
    dn = rays["direction_norms"][:chunk].contiguous()
    bound = model.bound
    rec = {}

    # occ_placement at the render paths' shapes: stage 1 and the refine
    # pass's coarse placement of the test config ([4096, 16], [1024, 32])
    # and of the predict config ([4096, 8], [512, 16]); timed in the binary
    # mode with det u, as both configs place, and held in the proposal mode
    # too. The record's numbers are the test config's stage 1.
    predict = cfgs["predict"]
    render_packed = model.pack_table(*RENDER_PACK)
    occ_rows, enc_rows, stage1_z = [], [], {}
    for label, cfg, frac, s in (
            ("test stage 1", test, 1.0, test.stage1_steps),
            ("test refine", test, test.refine_fraction, test.num_steps),
            ("predict stage 1", predict, 1.0, predict.stage1_steps),
            ("predict refine", predict, predict.refine_fraction,
             predict.num_steps)):
        k = max(1, int(round(chunk * frac)))
        check_placement(label, o[:k], d[:k], grid, bound, s, cfg,
                        not cfg.proposal_placement, timed=False)
        zk, row = check_placement(label, o[:k], d[:k], grid, bound, s, cfg,
                                  cfg.proposal_placement)
        occ_rows.append(row)
        if label.endswith("stage 1"):
            stage1_z[label] = zk
            pts = _points(o, d, zk, bound)
            enc_rows.append(check_encode(label, model, pts))
            # the render's encodes through its fp8 packed table (the card's
            # default): the density calls' exact mode, and the probe's
            # mode at probe placement's count of points (4096 × 16)
            x01 = ((pts + bound) / (2.0 * bound)).contiguous()
            for mode in (("exact", "probe") if label == "test stage 1"
                         else ("exact",)):
                check_packed_encode(rec, label, model, x01, render_packed,
                                    mode)
    head = occ_rows[0]
    rec["occ_placement"] = dict(
        name="occ_placement", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/occ_placement.cu",
        replaces="ucsa_neural_rendering_tpu/ops/renderer.py:262",
        max_abs_err=max(r["max_abs_err"] for r in occ_rows), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, shapes=occ_rows)

    # importance_resample on the refine passes' coarse samples: the test
    # config's [1024, 32 + 32] (the record's numbers) and the predict
    # config's [512, 16 + 16]
    def refine_inputs(cfg):
        k = int(round(chunk * cfg.refine_fraction))
        z = pl.occ_placement(o[:k], d[:k], grid, bound, cfg.num_steps,
                             cfg.occ_candidates, cfg.min_near, False,
                             cfg.occ_floor, cfg.occ_density_threshold,
                             cfg.density_scale)
        sigma = model.density(_points(o[:k], d[:k], z, bound))[0]
        return z, sigma.reshape(k, cfg.num_steps).contiguous()

    # and hash_encode_fwd on the refine passes' two density calls: the
    # coarse samples and the new ones
    def refine(label, cfg):
        k = int(round(chunk * cfg.refine_fraction))
        z_c, sig = refine_inputs(cfg)
        out = check_resample(label, z_c, sig, cfg.upsample_steps,
                             cfg.density_scale)
        for what, z in (("coarse", z_c), ("new", out[0])):
            enc_rows.append(check_encode(
                f"{label} {what}", model, _points(o[:k], d[:k], z, bound)))
        return z_c, sig, out

    s2 = test.upsample_steps
    # (new z, merged z, order, row) of each refine pass
    test_out = refine("test refine", test)[2]
    predict_out = refine("predict refine", predict)[2]
    test_row, predict_row = test_out[3], predict_out[3]
    head = enc_rows[0]
    rec["hash_encode_fwd"] = dict(
        name="hash_encode_fwd", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/hash_encode_fwd.cu",
        replaces="ucsa_neural_rendering_tpu/models/hash_encoding.py:202",
        max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=None, shapes=enc_rows)
    n_bytes, n_ops = resample_work(k_refine, test.num_steps, s2)
    rec["importance_resample"] = dict(
        name="importance_resample", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/importance_resample.cu",
        replaces="ucsa_neural_rendering_tpu/ops/renderer.py:305",
        max_abs_err=max(test_row["max_abs_err"], predict_row["max_abs_err"]),
        ms=test_row["ms"], plain_ms=test_row["plain_ms"],
        bound_ms=test_row["bound_ms"], bound_by=bound_by(n_bytes, n_ops),
        library_ms=None, shapes=[test_row, predict_row])

    # composite_fwd at the render paths' four shapes: stage 1's [4096, 16]
    # and [4096, 8], the refine passes' merged [1024, 64] and [512, 32]
    # (C = 40); the record's numbers are the test refine's
    comp_rows = [check_composite(label, composite_inputs(
        model, o[:z.shape[0]], d[:z.shape[0]], z, dn[:z.shape[0]], cfg))
        for label, z, cfg in (
            ("test stage 1", stage1_z["test stage 1"], test),
            ("test refine", test_out[1], test),
            ("predict stage 1", stage1_z["predict stage 1"], predict),
            ("predict refine", predict_out[1], predict))]
    rec["composite_fwd"] = composite_record("composite_fwd", comp_rows,
                                            comp_rows[1])
    kernels.reset_launches()  # the comparisons above are not the main path
    return rec


N_RAYS = 4096  # rays per training step (the shipped step, bench.py)
DEFAULT_CFG_STEPS = 3  # steps at the trainer's default RenderConfig()
K9_STEPS = 16  # steps of each K9 training encoder (stochastic_fwd)
# the kernels whose plain versions a K9 step is held to with the kernel
# path's own sample positions: the table's and the compositing's
K9_PLAIN = ("hash_encode", "hash_encode_bwd", "hash_encode_sampled",
            "hash_encode_face", "hash_encode_packed", "build_packed_table",
            "composite_fwd", "composite_bwd")
# the K9 runs of phase 5: (stochastic_fwd, train_packed_max_entries) by
# label, and each one's forward encode on the card: True the single corner
# on every level (it reads no packed table, so its step packs nothing, as
# the JAX package's), "face" and "fine" at the card's default the hybrids
# through the step's packed table (bf16 rows at 2^21: its face and probe
# modes), "face" unpacked the face encode
K9_RUNS = {"True": (True, 2 ** 21), "face": ("face", 2 ** 21),
           "fine": ("fine", 2 ** 21), "face_unpacked": ("face", 0)}
K9_ENCODES = {"True": "hash_encode_sampled",
              "face": "hash_encode_packed_fwd",
              "fine": "hash_encode_packed_fwd",
              "face_unpacked": "hash_encode_face_fwd"}
# the shipped model (config/shipped.py, JAX train/joint_trainer.py:142-143)
TRAIN_MODEL = dict(bound=4.0, num_semantic_classes=40, n_levels=8,
                   n_features=4, log2_hashmap_size=19)


def train_config():
    """The shipped training render: 24 proposal-placed + 8 importance
    samples (config/shipped.py)."""
    from ucsa_neural_rendering_tpu_torch.config import (SHIPPED_PROPOSAL,
                                                        SHIPPED_TRAIN_BUDGET)
    from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
    coarse, fine = SHIPPED_TRAIN_BUDGET
    return RenderConfig(num_steps=coarse, upsample_steps=fine,
                        proposal_placement=SHIPPED_PROPOSAL)


@torch.no_grad()
def check_train_kernels(model, grid, device, rec):
    """Phase 3, training path: the two placement kernels with a training
    step's per-ray random u, and the four kernels of the backward and the
    refresh, against their plain versions at the training path's shapes."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays_sampled
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.ops import occupancy as oc
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops.renderer import (RenderConfig,
                                                              _points)

    record = recorder(rec)
    cfg = train_config()
    gen = torch.Generator(device).manual_seed(7)
    o, d, dn, _ = get_rays_sampled(look_at(POSES[0]), INTRINSICS, 240, 320,
                                   N_RAYS, gen, device=device)
    s1, s2 = cfg.num_steps, cfg.upsample_steps
    u_c = torch.rand((N_RAYS, s1), generator=gen, device=device)
    u_f = torch.rand((N_RAYS, s2), generator=gen, device=device)
    bound, scale = model.bound, cfg.density_scale
    spec = model.encoder.spec
    L, F = spec.n_levels, spec.n_features

    # placement with per-ray u: coarse [4096, 24] (proposal), fine 24 + 8.
    # The kernels sort each ray's z; the inverse CDF is monotone, so the
    # coarse z (sorted) are the plain version's, the fine new z the same
    # set: compare sorted. Tolerances as for det u.
    zk, row = check_placement("train step", o, d, grid, bound, s1, cfg,
                              cfg.proposal_placement, u_c)
    occ = rec["occ_placement"]
    occ["shapes"].append(row)
    occ["max_abs_err"] = max(occ["max_abs_err"], row["max_abs_err"])
    sig = model.density(_points(o, d, zk, bound))[0].reshape(N_RAYS, s1)
    nk, zsk, _, row = check_resample("train step", zk, sig.contiguous(), s2,
                                     scale, u_f)
    res = rec["importance_resample"]
    res["shapes"].append(row)
    res["max_abs_err"] = max(res["max_abs_err"], row["max_abs_err"])
    tb = model.encoder.table_bf16()
    train_packed = model.pack_table(*TRAIN_PACK)
    sampled_rows = {name: [] for name in SAMPLED_KERNELS}
    for what, z in (("coarse", zk), ("new", nk)):
        pts = _points(o, d, z, bound)
        rec["hash_encode_fwd"]["shapes"].append(check_encode(
            f"train step {what}", model, pts))
        # the K9 training encoders at the same points (stochastic_fwd True
        # and "face"): 98,304 and 32,768 points
        x01 = ((pts + bound) / (2.0 * bound)).contiguous()
        for name, rows in sampled_rows.items():
            rows.append(check_sampled_encode(name, f"train step {what}", tb,
                                             x01, spec))
        # and through the step's bf16 packed table (the card's default):
        # the exact step, the "fine" and the "face" hybrids
        for mode in ("exact", "probe", "face"):
            check_packed_encode(rec, f"train step {what}", model, x01,
                                train_packed, mode)

    # hash_encode_bwd on the step's 4096 × 32 points and one cotangent
    x01 = ((_points(o, d, zsk, bound) + bound) / (2.0 * bound)).contiguous()
    npts = x01.shape[0]
    g = torch.randn((npts, L * F), generator=gen, device=device
                    ).to(torch.bfloat16)
    errs, sum_errs = {}, {}
    x01_cpu, g_cpu = x01.cpu(), g.cpu()
    for stochastic in (True, False, "face"):
        ref = he.hash_encode_bwd_plain(x01, g, spec, stochastic)
        mass = he.hash_encode_bwd_plain(x01, g.abs(), spec, stochastic)
        out = he.hash_encode_bwd(x01, g, spec, stochastic)
        torch.cuda.synchronize()
        # against the plain version on the card (index_add_ with f32
        # atomics there: the same contributions in another order): within
        # 1e-5 of the |contributions| on it, and per level the sums within
        # 1e-5 of the level's L1 mass
        assert ((out - ref).abs() <= 1e-5 * mass).all(), stochastic
        errs[stochastic] = (out - ref).abs().max().item()
        sum_errs[stochastic] = sum_err(_level_sums(out, spec),
                                       _level_sums(ref, spec))
        assert sum_errs[stochastic] <= 1e-5, (stochastic, sum_errs)
        # the kernel adds each row's contributions in index_add_'s order,
        # as the plain version does on the CPU: bit-equal there
        assert torch.equal(out.cpu(), he.hash_encode_bwd_plain(
            x01_cpu, g_cpu, spec, stochastic)), stochastic
    exact_ms = device_ms(lambda: he.hash_encode_bwd(x01, g, spec, False))
    face_ms = device_ms(lambda: he.hash_encode_bwd(x01, g, spec, "face"))
    face_plain_ms = device_ms(
        lambda: he.hash_encode_bwd_plain(x01, g, spec, "face"), iters=5,
        warmup=1)
    idx = he.sampled_corner_indices(x01, spec).reshape(-1)
    g_rows = g.float().reshape(-1, F)
    acc = torch.zeros((spec.table_size, F), device=device)
    record("hash_encode_bwd", errs[True],
           lambda: he.hash_encode_bwd(x01, g, spec, True),
           lambda: he.hash_encode_bwd_plain(x01, g, spec, True),
           # points and cotangent in, the [T, F] f32 gradient out once
           npts * 12 + npts * L * F * 2 + spec.table_size * F * 4,
           # per (point, level): 3 frac, 8 × (3 weight ops + cdf add and
           # compare), ~12 hash ops, F adds
           npts * L * (3 + 8 * 5 + 12 + F),
           "ucsa_neural_rendering_tpu/models/hash_encoding.py:436",
           "ucsa_neural_rendering_tpu_torch/csrc/hash_encode_bwd.cu",
           f"(stochastic, [{npts},{L * F}] → [{spec.table_size},{F}]; exact "
           f"mode {exact_ms:.4f} ms, max_abs_err {errs[False]:.3e}; face "
           f"mode {face_ms:.4f} ms (plain {face_plain_ms:.4f}), max_abs_err "
           f"{errs['face']:.3e}, level sums {sum_errs['face']:.3e} of the "
           f"mass; library = index_add_ of the drawn rows)",
           fn_lib=lambda: acc.index_add_(0, idx, g_rows))
    bwd = rec["hash_encode_bwd"]
    bwd.update(exact_ms=exact_ms, exact_max_abs_err=errs[False],
               face_ms=face_ms, face_plain_ms=face_plain_ms,
               face_max_abs_err=errs["face"], level_sum_errs=sum_errs,
               bit_equal_to_cpu_plain=True)
    # the call's parts by device operation: the elements, the radix pass
    # (count, scan, scatter), the buckets' spans, their sums
    bwd["parts_ms"] = device_ms(
        lambda: he.hash_encode_bwd(x01, g, spec, True), by_name=True)
    log(f"  hash_encode_bwd call {bwd['ms']:.4f} ms (first version: "
        f"{first_version('hash_encode_bwd', 'call')}), bit-equal to the "
        f"plain version on the CPU in all three modes; index_add_ "
        f"{bwd['library_ms']:.4f} ms; its parts: " + ", ".join(
            f"{k.split('(')[0].split('::')[-1]} {v:.4f}"
            for k, v in bwd["parts_ms"].items()))

    # composite_fwd and composite_bwd on the step's merged [4096, 32]
    # samples and at the trainer's default RenderConfig() (256 + 256: z from
    # its binary placement of 512 samples a ray, standing in for the merged
    # 256 + 256), C = 40; composite_bwd's record is the step's
    dflt = RenderConfig()
    z_dflt = pl.occ_placement(o, d, grid, bound,
                              dflt.num_steps + dflt.upsample_steps,
                              dflt.occ_candidates, dflt.min_near,
                              dflt.proposal_placement, dflt.occ_floor,
                              dflt.occ_density_threshold, dflt.density_scale)
    fwd_rows, bwd_rows = rec["composite_fwd"]["shapes"], []
    for label, z, c_cfg in (("train step", zsk, cfg),
                            ("default step", z_dflt, dflt)):
        args = composite_inputs(model, o, d, z, dn, c_cfg)
        cots = [torch.randn(shape, generator=gen, device=device)
                for shape in ((N_RAYS, 3), (N_RAYS, args[3].shape[-1]),
                              (N_RAYS,))]
        fwd_rows.append(check_composite(label, args))
        bwd_rows.append(check_composite(label, args, cots))
    rec["composite_fwd"]["max_abs_err"] = max(r["max_abs_err"]
                                              for r in fwd_rows)
    rec["composite_bwd"] = composite_record("composite_bwd", bwd_rows,
                                            bwd_rows[0])

    # hash_encode_sampled on one refresh chunk: 262,144 jittered probes of
    # x-slab 0 of the 128³ grid (the record's numbers), and at the step's
    # two density calls above; hash_encode_face_fwd's record is the step's
    # coarse call
    r = grid.shape[0]
    m = 262144
    flat = torch.arange(m, device=device)
    cells = torch.stack([flat // (r * r), (flat // r) % r, flat % r],
                        -1).float()
    xyz = (cells + torch.rand((m, 3), generator=gen, device=device)) / r \
        * (2.0 * bound) - bound
    p01 = ((xyz + bound) / (2.0 * bound)).contiguous()
    sampled_rows["hash_encode_sampled"].insert(0, check_sampled_encode(
        "hash_encode_sampled", "refresh", tb, p01, spec))
    for name, rows in sampled_rows.items():
        rec[name] = shapes_record(name, rows, rows[0],
                                  SAMPLED_KERNELS[name][3])
    # hash_encode_face_fwd's launch floor: its own device time at 32 points
    x32 = p01[:32].contiguous()
    rec["hash_encode_face_fwd"]["floor_ms"] = floor = device_ms(
        lambda: he.hash_encode_face(tb, x32, spec))
    log(f"  hash_encode_face_fwd launch floor [32,3]: {floor:.4f} ms")

    # occ_grid_update at 128³ with one slab (of 4) of fresh densities
    n_slab = r ** 3 // 4
    fresh = 30.0 * torch.rand((n_slab,), generator=gen, device=device)
    for slab in range(4):
        a = oc.occ_grid_update(grid, fresh, slab * n_slab, 0.62)
        b = oc.occ_grid_update_plain(grid, fresh, slab * n_slab, 0.62)
        torch.cuda.synchronize()
        assert torch.equal(a, b)  # one multiply and one max per cell
    record("occ_grid_update", 0.0,
           lambda: oc.occ_grid_update(grid, fresh, n_slab, 0.62),
           lambda: oc.occ_grid_update_plain(grid, fresh, n_slab, 0.62),
           # the grid in and out once, the slab's densities in once
           r ** 3 * 8 + n_slab * 4, r ** 3 + n_slab,
           "ucsa_neural_rendering_tpu/ops/occupancy.py:99",
           "ucsa_neural_rendering_tpu_torch/csrc/occ_grid_update.cu",
           f"({r}³, slab of {n_slab})")
    kernels.reset_launches()  # the comparisons above are not the main path


FUSED_IMAGES = 4  # JointTrainer.fused_image_step at the joint batch


@torch.no_grad()
def pack_launch_floor(model):
    """pack_table's launch floor: its device ms at its smallest shape, one
    packed level of 2³ cells (a 1-level grid of resolution 2)."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.models import packed_table as pt
    spec = he.make_spec(1, model.encoder.spec.n_features, 12, 2, 1.5)
    table = torch.rand((spec.table_size, spec.n_features),
                       device=model.encoder.table.device)
    fn = lambda: pt.build_packed_table(table, spec, 1, "fp8")
    assert torch.equal(fn().data.view(torch.uint8),
                       pt.build_packed_table_plain(table, spec, 1, "fp8")
                       .data.view(torch.uint8))
    ms = device_ms(fn)
    log(f"  pack_table launch floor (one level of 8 cells): {ms:.5f} ms")
    return ms


def check_packed_tables(model, dense, rec):
    """Phase 14 (a), with phase 3: pack_table at the shipped geometry at
    both budgets in both row dtypes (the render's 2^23 fp8 and the step's
    2^21 bf16 among them) and at the reference's 16 × 2 dense program's
    two, fp8's edge values planted; then the two packed kernels' records:
    pack_table's head the step's repack (every training step launches one),
    hash_encode_packed_fwd's the test frame's stage 1 (fp8 rows)."""
    from ucsa_neural_rendering_tpu_torch import kernels
    for budget in (RENDER_PACK[0], TRAIN_PACK[0]):
        for dtype in ("fp8", "bf16"):
            check_pack_table(rec, "shipped 8 x 4", model, (budget, dtype))
    for pack in (RENDER_PACK, TRAIN_PACK):
        check_pack_table(rec, "dense 16 x 2", dense, pack)
    head = next(r for r in rec["pack_table"]["shapes"]
                if r["where"] == "shipped 8 x 4"
                and (r["budget"], r["row_dtype"]) == TRAIN_PACK)
    finish_record(rec["pack_table"], head)
    rec["pack_table"]["floor_ms"] = pack_launch_floor(model)
    enc = rec["hash_encode_packed_fwd"]
    finish_record(enc, next(r for r in enc["shapes"]
                            if r["where"] == "test stage 1"
                            and r["mode"] == "exact"))
    kernels.reset_launches()


def check_fused_step_kernels(model, grid, device, rec):
    """Phase 3, the joint step's fused image step: FUSED_IMAGES × 4096 =
    16,384 rays of 24 + 8 samples in one step. The placement, resample,
    encode and compositing kernels (forward and backward) and the table
    backward against their plain versions at its shapes, with the
    tolerances of the training step's checks; the MLPs' calls at its
    numbers of points are in check_mlp_kernels. The rows join each
    kernel's shapes."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays_sampled
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.ops.renderer import _points

    cfg = train_config()
    gen = torch.Generator(device).manual_seed(13)
    rays = [get_rays_sampled(look_at(POSES[i % len(POSES)]), INTRINSICS, 240,
                             320, N_RAYS, gen, device=device)
            for i in range(FUSED_IMAGES)]
    o, d, dn = (torch.cat([r[k] for r in rays]) for k in range(3))
    n = o.shape[0]
    s1, s2 = cfg.num_steps, cfg.upsample_steps
    u_c = torch.rand((n, s1), generator=gen, device=device)
    u_f = torch.rand((n, s2), generator=gen, device=device)
    bound, label = model.bound, "fused step"
    zk, row = check_placement(label, o, d, grid, bound, s1, cfg,
                              cfg.proposal_placement, u_c)
    rec["occ_placement"]["shapes"].append(row)
    sig = model.density(_points(o, d, zk, bound))[0].reshape(n, s1)
    nk, zsk, _, row = check_resample(label, zk, sig.contiguous(), s2,
                                     cfg.density_scale, u_f)
    rec["importance_resample"]["shapes"].append(row)
    for what, z in (("coarse", zk), ("new", nk)):
        rec["hash_encode_fwd"]["shapes"].append(check_encode(
            f"{label} {what}", model, _points(o, d, z, bound)))
    args = composite_inputs(model, o, d, zsk, dn, cfg)
    cots = [torch.randn(shape, generator=gen, device=device)
            for shape in ((n, 3), (n, args[3].shape[-1]), (n,))]
    rec["composite_fwd"]["shapes"].append(check_composite(label, args))
    rec["composite_bwd"]["shapes"].append(check_composite(label, args, cots))
    # the table backward on the step's 16,384 × 32 points, both modes, as
    # check_train_kernels holds it
    spec = model.encoder.spec
    x01 = ((_points(o, d, zsk, bound) + bound) / (2.0 * bound)).contiguous()
    g = torch.randn((x01.shape[0], spec.n_levels * spec.n_features),
                    generator=gen, device=device).to(torch.bfloat16)
    for stochastic in (True, False):
        ref = he.hash_encode_bwd_plain(x01, g, spec, stochastic)
        mass = he.hash_encode_bwd_plain(x01, g.abs(), spec, stochastic)
        out = he.hash_encode_bwd(x01, g, spec, stochastic)
        torch.cuda.synchronize()
        assert ((out - ref).abs() <= 1e-5 * mass).all(), stochastic
        err = sum_err(_level_sums(out, spec), _level_sums(ref, spec))
        assert err <= 1e-5, (stochastic, err)
        log(f"  hash_encode_bwd {label} [{x01.shape[0]},3] "
            f"{'stochastic' if stochastic else 'exact'}: max_abs_err "
            f"{(out - ref).abs().max().item():.3e}, level sums {err:.3e} of "
            f"the mass")
    for name in ("occ_placement", "importance_resample", "hash_encode_fwd",
                 "composite_fwd", "composite_bwd"):
        rec[name]["max_abs_err"] = max(r["max_abs_err"]
                                       for r in rec[name]["shapes"])
    kernels.reset_launches()  # the comparisons above are not the main path


# the reference's dense program (RenderConfig()'s 256 + 256, no grid) on
# the reference's geometry (SemanticNeRF's defaults: 16 levels × 2
# features, 2^19 table)
DENSE_STEPS = 256
DENSE_LEVELS, DENSE_FEATURES = 16, 2
PROBE_SAMPLES = 16  # RenderConfig.num_probe
STRATIFIED_REPLACES = "ucsa_neural_rendering_tpu/ops/renderer.py:297"


def stratified_work(n, s, jitter):
    """(bytes, operations) of stratified_placement on n rays of s samples:
    rays in, z out (and u in when jittered); ~30 operations a ray's slab
    test, 3 a sample (9 jittered)."""
    return (n * 24 + n * s * 4 * (2 if jitter else 1),
            n * 30 + n * s * (9 if jitter else 3))


def check_stratified(label, o, d, bound, s, min_near, u=None):
    """stratified_placement against its plain version on one path shape:
    bit-equal (the same f32 operations in the same order), sorted, timed.
    Returns the kernel's z and the shape's row."""
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    args = (o, d, bound, s, min_near, u)
    zk = pl.stratified_placement(*args)
    zp = pl.stratified_placement_plain(*args)
    torch.cuda.synchronize()
    n = o.shape[0]
    what = (f"stratified_placement {label} [{n},{s}]"
            f"{', jittered' if u is not None else ''}")
    assert torch.equal(zk, zp), what
    assert (zk[:, 1:] >= zk[:, :-1]).all(), what
    n_bytes, n_ops = stratified_work(n, s, u is not None)
    row = dict(where=label, rays=n, samples=s, jitter=u is not None,
               max_abs_err=0.0,
               ms=device_ms(lambda: pl.stratified_placement(*args)),
               plain_ms=device_ms(lambda: pl.stratified_placement_plain(
                   *args), iters=5, warmup=1),
               bound_ms=bound_ms(n_bytes, n_ops),
               bound_by=bound_by(n_bytes, n_ops))
    log(f"  {what}: bit-equal; kernel {row['ms']:.4f} ms (first version: "
        f"{first_version('stratified_placement', label)})  plain "
        f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {row['ms'] / row['bound_ms']:.2f}× it)")
    return zk, row


def dense_model(device, seed):
    """The reference's geometry at full width: make_scene's seeded model
    with 16 levels × 2 features (its grid unused)."""
    return make_scene(device, seed, n_levels=DENSE_LEVELS,
                      n_features=DENSE_FEATURES)[0]


@torch.no_grad()
def check_dense_kernels(model, dense, grid, device, rec):
    """Phase 3, the opt-in paths' shapes. The dense program on the 16 × 2
    model `dense`: stratified_placement at a chunk's [4096, 256] (det, the
    render; jittered, a training step) and the probe's [4096, 16];
    hash_encode_fwd at 1,048,576 points (the coarse and the new samples);
    importance_resample at [4096, 256 + 256] (det and random u);
    hash_encode_bwd at a step's 2,097,152 points, stochastic (the YAML
    default) and exact; hash_encode_sampled at a refresh chunk and at
    probe placement's 65,536 points; composite_fwd and composite_bwd at
    [4096, 512]. Probe placement on the shipped `model` with its `grid`:
    occ_placement's [4096, 16] from 128 candidates (binary, det) and
    importance_resample's [4096, 16 + 32]; hash_encode_fwd on the exact
    refresh's 262,144 points. The tolerances are the other checks'; the
    MLPs' dense calls are in check_mlp_kernels."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.data.rays import (get_rays,
                                                           get_rays_sampled)
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops.renderer import (RenderConfig,
                                                              _points)

    cfg = RenderConfig()
    assert (cfg.num_steps, cfg.upsample_steps) == (DENSE_STEPS, DENSE_STEPS)
    gen = torch.Generator(device).manual_seed(17)
    rays = get_rays(look_at(POSES[0]), INTRINSICS, 240, 320, device=device)
    o, d, dn = (rays[k][:N_RAYS].contiguous()
                for k in ("rays_o", "rays_d", "direction_norms"))
    to, td, tdn, _ = get_rays_sampled(look_at(POSES[1]), INTRINSICS, 240,
                                      320, N_RAYS, gen, device=device)
    u_c = torch.rand((N_RAYS, DENSE_STEPS), generator=gen, device=device)
    u_f = torch.rand((N_RAYS, DENSE_STEPS), generator=gen, device=device)
    bound, scale = dense.bound, cfg.density_scale

    strat_rows = []
    z_render, row = check_stratified("dense render", o, d, bound,
                                     DENSE_STEPS, cfg.min_near)
    strat_rows.append(row)
    z_step, row = check_stratified("dense step", to, td, bound, DENSE_STEPS,
                                   cfg.min_near, u_c)
    strat_rows.append(row)
    z_probe, row = check_stratified("probe", o, d, bound, PROBE_SAMPLES,
                                    cfg.min_near)
    strat_rows.append(row)
    rec["stratified_placement"] = shapes_record(
        "stratified_placement", strat_rows, strat_rows[0],
        STRATIFIED_REPLACES)

    # the render's fine pass and the step's, and the encode of both density
    # calls of each
    merged = {}
    for label, ro, rd, z, u in (("dense render", o, d, z_render, None),
                                ("dense step", to, td, z_step, u_f)):
        sig = dense.density(_points(ro, rd, z, bound))[0].reshape(
            N_RAYS, DENSE_STEPS).contiguous()
        nk, zsk, _, row = check_resample(label, z, sig, DENSE_STEPS, scale, u)
        rec["importance_resample"]["shapes"].append(row)
        merged[label] = zsk
        for what, zz in (("coarse", z), ("new", nk)):
            rec["hash_encode_fwd"]["shapes"].append(check_encode(
                f"{label} {what} 16x2", dense, _points(ro, rd, zz, bound)))

    # the table backward on the step's 4096 × 512 points, both modes
    spec = dense.encoder.spec
    L, F = spec.n_levels, spec.n_features
    x01 = ((_points(to, td, merged["dense step"], bound) + bound)
           / (2.0 * bound)).contiguous()
    npts = x01.shape[0]
    g = torch.randn((npts, L * F), generator=gen, device=device
                    ).to(torch.bfloat16)
    bwd_rows = rec["hash_encode_bwd"].setdefault("shapes", [])
    for stochastic in (True, False):
        ref = he.hash_encode_bwd_plain(x01, g, spec, stochastic)
        mass = he.hash_encode_bwd_plain(x01, g.abs(), spec, stochastic)
        out = he.hash_encode_bwd(x01, g, spec, stochastic)
        torch.cuda.synchronize()
        assert ((out - ref).abs() <= 1e-5 * mass).all(), stochastic
        err = sum_err(_level_sums(out, spec), _level_sums(ref, spec))
        assert err <= 1e-5, (stochastic, err)
        del ref, mass, out
        n_bytes = npts * 12 + npts * L * F * 2 + spec.table_size * F * 4
        n_ops = npts * L * (3 + 8 * 5 + 12 + F)
        r = dict(where="dense step 16x2", points=npts,
                 mode="stochastic" if stochastic else "exact",
                 level_sum_err=err,
                 ms=device_ms(lambda: he.hash_encode_bwd(x01, g, spec,
                                                         stochastic)),
                 plain_ms=device_ms(lambda: he.hash_encode_bwd_plain(
                     x01, g, spec, stochastic), iters=3, warmup=1),
                 bound_ms=bound_ms(n_bytes, n_ops),
                 bound_by=bound_by(n_bytes, n_ops))
        bwd_rows.append(r)
        log(f"  hash_encode_bwd dense step [{npts},3] 16x2 {r['mode']}: "
            f"level sums {err:.3e} of the mass; kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    del x01, g

    # hash_encode_sampled, 16 × 2: a refresh chunk of the 128³ grid's slab
    # 0 and the probe placement's 4096 × 16 points
    tb = dense.encoder.table_bf16()
    r = grid.shape[0]
    m = 262144
    flat = torch.arange(m, device=device)
    cells = torch.stack([flat // (r * r), (flat // r) % r, flat % r],
                        -1).float()
    xyz = (cells + torch.rand((m, 3), generator=gen, device=device)) / r \
        * (2.0 * bound) - bound
    for label, pts in (("refresh 16x2", xyz),
                       ("probe 16x2", _points(o, d, z_probe, bound))):
        p01 = ((pts + bound) / (2.0 * bound)).contiguous()
        rec["hash_encode_sampled"]["shapes"].append(check_sampled_encode(
            "hash_encode_sampled", label, tb, p01, spec))
    # hash_encode_fwd on the shipped model's exact refresh: the same chunk
    rec["hash_encode_fwd"]["shapes"].append(check_encode(
        "exact refresh", model, xyz))

    # composite_fwd and composite_bwd on the dense render's and step's
    # merged [4096, 512] samples, C = 40
    comp_f, comp_b = rec["composite_fwd"]["shapes"], \
        rec["composite_bwd"]["shapes"]
    for label, ro, rd, rdn in (("dense render", o, d, dn),
                               ("dense step", to, td, tdn)):
        args = composite_inputs(dense, ro, rd, merged[label], rdn, cfg)
        comp_f.append(check_composite(label, args))
        if label == "dense step":
            cots = [torch.randn(shape, generator=gen, device=device)
                    for shape in ((N_RAYS, 3), (N_RAYS, args[3].shape[-1]),
                                  (N_RAYS,))]
            comp_b.append(check_composite(label, args, cots))
        del args

    # probe placement on the shipped model with the grid: 16 probes by
    # binary occupancy (det), resampled to the test config's 32
    probe_cfg = replace(RenderConfig(), occ_candidates=128)
    zk, row = check_placement("probe", o, d, grid, model.bound,
                              PROBE_SAMPLES, probe_cfg, False)
    rec["occ_placement"]["shapes"].append(row)
    sig = model.density_probe(_points(o, d, zk, model.bound)).reshape(
        N_RAYS, PROBE_SAMPLES).contiguous()
    row = check_resample("probe", zk, sig, 2 * PROBE_SAMPLES, scale)[3]
    rec["importance_resample"]["shapes"].append(row)
    for name in ("occ_placement", "importance_resample", "hash_encode_fwd",
                 "composite_fwd", "composite_bwd", "hash_encode_sampled"):
        rec[name]["max_abs_err"] = max(x["max_abs_err"]
                                       for x in rec[name]["shapes"])
    # stratified_placement's launch floor: its own device time at [32, 1]
    # (last, so that the kernels above are timed as they were before it)
    o1, d1 = o[:32].contiguous(), d[:32].contiguous()
    rec["stratified_placement"]["floor_ms"] = floor = device_ms(
        lambda: pl.stratified_placement(o1, d1, bound, 1, cfg.min_near))
    log(f"  stratified_placement launch floor [32,1]: {floor:.4f} ms")
    kernels.reset_launches()  # the comparisons above are not the main path


def mlp_work(dims, n, backward):
    """(bytes, operations) of one MLP call on n points. Forward: x in, y
    out, the f32 weights once; 2·n·Σ d_l·d_{l+1}. Backward: x and dy in, dx
    out, the weights in and dW out; the hidden forward once, then dW and dh
    per layer."""
    pairs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    if backward:
        return (n * (2 * dims[0] + dims[-1]) * 2 + 8 * sum(pairs),
                2 * n * (sum(pairs[:-1]) + 2 * sum(pairs)))
    return n * (dims[0] + dims[-1]) * 2 + 4 * sum(pairs), 2 * n * sum(pairs)


def _mlp_rows_err(out, ref, near_tie=None, tie_bound=None):
    """max |diff|; asserts it is within two bf16 ulps of each row's largest
    |value| and that at least 0.98 of the elements are bit-equal (the
    tensor cores and cuBLAS sum in other orders and round an element to the
    other neighbour now and then; a hidden value that did so moves the next
    layer's outputs by a fraction of an ulp of the row). Rows in near_tie,
    a witness computed apart from this comparison, may exceed that, at
    most 1e-4 of the rows, and then by at most tie_bound of the row's
    largest |value| when one is given: a backward's rows with a hidden
    pre-activation within rounding of 0 (_relu_near_ties: the two sides'
    ReLU masks may differ and move dx by a whole term, no bound), a
    forward's rows whose hidden values the kernel rounded to the other
    neighbour (_mlp_fwd_chain; 8 ulps)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    scale = ref.abs().amax(-1, keepdim=True)
    assert torch.isfinite(out).all()
    beyond = (diff > 2.0 ** -7 * scale).any(-1)
    if near_tie is not None:
        assert (beyond & near_tie).sum() <= 1e-4 * out.shape[0], \
            (beyond & near_tie).sum().item()
        if tie_bound is not None:
            far = (diff > tie_bound * scale).any(-1) & near_tie
            assert not far.any(), (diff / scale)[far].max().item()
        beyond &= ~near_tie
    assert not beyond.any(), (diff / scale).max().item()
    equal = (diff == 0).float().mean().item()
    assert equal >= 0.98, equal
    return diff.max().item(), equal


def _mlp_fwd_chain(x, ws, out):
    """mlp_fwd's output `out` for x [N, d0] bf16 held layer by layer:
    mlp_fwd on the first l + 1 layers returns the kernel's own
    pre-activations of layer l (every layer runs the same product and
    rounding code, csrc/mlp.cuh `layer_x4`, `relu_to_a2`), and each
    layer's kernel output is held, element by element, to one bf16
    torch.matmul of the kernel's previous layer, ReLU'd: within an ulp of
    the element (both round an f32 sum of the same exact bf16 products,
    added in another order) plus 2^-16 of the sum of the terms'
    magnitudes (the orders' f32 difference). No row is exempt. Returns
    the rows where a hidden value of the kernel (ReLU'd) differs from the
    plain forward's: the only rows whose outputs may differ from the
    plain version's by more than the last layer's rounding."""
    from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as sn

    a = x
    differs = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for lvl, w in enumerate(ws):
        last = lvl == len(ws) - 1
        got = out if last else sn.mlp_fwd(x, ws[:lvl + 1])
        wb = w.to(torch.bfloat16)
        ref = torch.matmul(a, wb.t()).float()
        terms = a.float().abs() @ wb.float().abs().t()
        g = got.float()
        tol = 2.0 ** -7 * torch.maximum(g.abs(), ref.abs()) + \
            2.0 ** -16 * terms
        assert torch.isfinite(g).all() and ((g - ref).abs() <= tol).all(), \
            (lvl, ((g - ref).abs() - tol).max().item())
        if not last:
            a = torch.relu(got)
            plain = torch.relu(sn.mlp_fwd_plain(x, ws[:lvl + 1]))
            differs |= (a != plain).any(-1)
        del got, ref, terms, g, tol
    return differs


def _relu_near_ties(x, ws):
    """Rows of x [N, d0] bf16 where a hidden pre-activation of the plain
    forward lies within a bf16 ulp (2^-8) of its largest possible term of
    0: a sum reordered in f32, or an input rounded to its other bf16
    neighbour, can put it on the other side of the ReLU."""
    h = x.float()
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for w in ws[:-1]:
        wb = w.to(torch.bfloat16).float()
        z = h @ wb.t()
        term = h.abs().amax(-1, keepdim=True) * wb.abs().amax(-1)
        near |= (z.abs() <= 2.0 ** -8 * term).any(-1)
        h = torch.relu(z.to(torch.bfloat16)).float()
    return near


def check_mlp_kernels(model, cfgs, device, rec, dense_model=None):
    """Phase 3, MLPs: mlp_fwd and mlp_bwd against their plain versions for
    the sigma, color and semantics MLPs at the numbers of points the paths
    give them: a training step's (sigma 4096 × 24 and × 8, color and
    semantics 4096 × 32), a render chunk's (4096 × 16) and, forward only, a
    refresh chunk's (sigma, 262,144); with dense_model (16 × 2 levels), the
    dense program's step and 4096-ray chunk (sigma 4096 × 256 =
    1,048,576 points a call, color and semantics 4096 × 512 = 2,097,152),
    forward and backward. The semantics MLP reads its input as a column
    slice of a 16-wide tensor, as the paths do. Every forward is also
    held layer by layer against its own previous layer (_mlp_fwd_chain).
    The records sum the training step's four calls."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as sn

    cfg = train_config()
    gen = torch.Generator(device).manual_seed(11)
    nets = {"sigma": model.sigma_net, "color": model.color_net,
            "semantics": model.semantics_net}
    step = [("sigma", N_RAYS * cfg.num_steps),
            ("sigma", N_RAYS * cfg.upsample_steps),
            ("color", N_RAYS * (cfg.num_steps + cfg.upsample_steps)),
            ("semantics", N_RAYS * (cfg.num_steps + cfg.upsample_steps))]
    calls = [(net, n, "step", True) for net, n in step]
    # the joint step's fused image step: the same calls on FUSED_IMAGES
    # images' rays at once
    calls += [(net, FUSED_IMAGES * n, "fused step", True) for net, n in step]
    render = []
    for c in cfgs.values():
        # stage 1: every ray of the chunk through all three MLPs; the
        # refine pass: sigma on its coarse and on its new samples, color
        # and semantics on the merged ones
        k = max(1, int(round(c.max_ray_batch * c.refine_fraction)))
        render += [(net, c.max_ray_batch * c.stage1_steps) for net in nets]
        render += [("sigma", k * c.num_steps), ("sigma", k * c.upsample_steps),
                   ("color", k * (c.num_steps + c.upsample_steps)),
                   ("semantics", k * (c.num_steps + c.upsample_steps))]
    calls += [(net, n, "render", False) for net, n in dict.fromkeys(render)]
    calls.append(("sigma", 262144, "refresh", False))
    calls = [(nets, *c) for c in calls]
    if dense_model is not None:
        dense_nets = {"sigma": dense_model.sigma_net,
                      "color": dense_model.color_net,
                      "semantics": dense_model.semantics_net}
        calls += [(dense_nets, net, n, "dense step", True)
                  for net, n in (("sigma", N_RAYS * DENSE_STEPS),
                                 ("color", N_RAYS * 2 * DENSE_STEPS),
                                 ("semantics", N_RAYS * 2 * DENSE_STEPS))]

    shapes = {"mlp_fwd": [], "mlp_bwd": []}
    for nets, net, n, where, bwd in calls:
        ws = [lin.weight.detach() for lin in nets[net].layers]
        dims = [ws[0].shape[1]] + [w.shape[0] for w in ws]
        x = torch.randn((n, dims[0] + (net == "semantics")), generator=gen,
                        device=device).to(torch.bfloat16)
        x = x[:, 1:] if net == "semantics" else x
        out_k, out_p = sn.mlp_fwd(x, ws), sn.mlp_fwd_plain(x, ws)
        # the kernel's every layer held to one matmul of its own previous
        # layer; the rows whose hidden values it rounded otherwise than
        # the plain forward are the witness for the dense calls' rows
        rounded = _mlp_fwd_chain(x, ws, out_k)
        near, fwd_rows = None, {}
        if where == "dense step":
            # at 1–2M rows a hidden value rounded to its other bf16
            # neighbour, carried through the next layers, now and then
            # moves an output past two ulps of the row's largest: such
            # rows, only among those the chain shows rounded otherwise,
            # are held to 1e-4 of the rows and 8 ulps
            beyond = ((out_k.float() - out_p.float()).abs() > 2.0 ** -7
                      * out_p.float().abs().amax(-1, keepdim=True)).any(-1)
            near = rounded
            fwd_rows = dict(rows_beyond=int(beyond.sum()),
                            rows_rounded_otherwise=int(rounded.sum()))
            log(f"  mlp_fwd {net} N={n} ({where}): {int(beyond.sum())} rows "
                f"beyond 2 bf16 ulps, all among the {int(rounded.sum())} "
                f"whose hidden values the kernel rounded to the other "
                f"neighbour (a rate of {int(beyond.sum()) / n:.3e} against "
                f"the limit 1e-4)")
        err, equal = _mlp_rows_err(out_k, out_p, near, 2.0 ** -5)
        del out_k, out_p
        n_bytes, n_ops = mlp_work(dims, n, False)
        tie_rows = {}
        todo = [("mlp_fwd", err, equal, lambda: sn.mlp_fwd(x, ws),
                 lambda: sn.mlp_fwd_plain(x, ws),
                 lambda: sn.mlp_fwd_plain(x, ws), n_bytes, n_ops)]
        if bwd:
            dy = torch.randn((n, dims[-1]), generator=gen, device=device
                             ).to(torch.bfloat16)
            dx, dws = sn.mlp_bwd(x, ws, dy)
            rdx, rdws = sn.mlp_bwd_plain(x, ws, dy)
            near = _relu_near_ties(x, ws)
            err, equal = _mlp_rows_err(dx, rdx, near)
            beyond = ((dx.float() - rdx.float()).abs() > 2.0 ** -7 * rdx.float(
                ).abs().amax(-1, keepdim=True)).any(-1)
            log(f"  mlp_bwd {net} N={n} ({where}): {int(beyond.sum())} rows "
                f"of dx beyond 2 bf16 ulps, all at ReLU near-ties "
                f"({int(near.sum())} rows have one; a rate of "
                f"{int(beyond.sum()) / n:.3e} against the limit 1e-4)")
            tie_rows = dict(rows_beyond=int(beyond.sum()),
                            near_tie_rows=int(near.sum()))
            for dw, ref in zip(dws, rdws):
                # f32 sums over n points in another order, rounded to bf16
                # once: an ulp of the element, plus 2^-12 of the layer's
                # largest |value| for sums that cancel to near zero
                tol = 2.0 ** -7 * ref.abs() + 2.0 ** -12 * ref.abs().max()
                assert ((dw - ref).abs() <= tol).all(), (net, n)
                err = max(err, (dw - ref).abs().max().item())
            leaves = [t.detach().requires_grad_() for t in (x, *ws)]

            def library(leaves=leaves, dy=dy):
                with torch.enable_grad():
                    y = sn.mlp_fwd_plain(leaves[0], leaves[1:])
                    return torch.autograd.grad(y, leaves, dy)

            n_bytes, n_ops = mlp_work(dims, n, True)
            todo.append(("mlp_bwd", err, equal,
                         lambda x=x, dy=dy: sn.mlp_bwd(x, ws, dy),
                         lambda x=x, dy=dy: sn.mlp_bwd_plain(x, ws, dy),
                         library, n_bytes, n_ops))
        for name, err, equal, fn_k, fn_p, fn_lib, n_bytes, n_ops in todo:
            # mlp_bwd's two device operations apart: the main kernel and
            # the cross-block dW reduction
            parts = device_ms(fn_k, by_name=True)
            reduce_ms = sum(v for k, v in parts.items() if "reduce" in k)
            r = dict(net=net, n=n, where=where, max_abs_err=err,
                     bit_equal=equal, ms=sum(parts.values()),
                     plain_ms=device_ms(fn_p, iters=5, warmup=1),
                     library_ms=device_ms(fn_lib, iters=5, warmup=1),
                     bytes=n_bytes, ops=n_ops,
                     bound_ms=bound_ms(n_bytes, n_ops, BF16_OPS_PER_S))
            split = ""
            if name == "mlp_fwd":
                r.update(fwd_rows)
            if name == "mlp_bwd":
                r.update(kernel_ms=r["ms"] - reduce_ms, reduce_ms=reduce_ms,
                         **tie_rows)
                split = (f" = kernel {r['kernel_ms']:.4f} + dW reduction "
                         f"{reduce_ms:.4f}")
            shapes[name].append(r)
            first = first_version(name, f"{where} {net} {n}")
            log(f"  {name} {net} {dims} N={n} ({where}): max_abs_err "
                f"{err:.3e} (bit-equal {equal:.4f})  kernel {r['ms']:.4f} "
                f"ms{split} (first version: {first})  plain "
                f"{r['plain_ms']:.4f}  library {r['library_ms']:.4f}  bound "
                f"{r['bound_ms']:.4f} ms")
    for name, rows in shapes.items():
        in_step = [r for r in rows if r["where"] == "step"]
        n_bytes = sum(r["bytes"] for r in in_step)
        n_ops = sum(r["ops"] for r in in_step)
        rec[name] = dict(
            name=name, route="cuda",
            source=f"ucsa_neural_rendering_tpu_torch/csrc/{name}.cu",
            replaces="ucsa_neural_rendering_tpu/models/semantic_nerf.py:28",
            max_abs_err=max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] for r in in_step)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=bound_by(n_bytes, n_ops, BF16_OPS_PER_S), shapes=rows)
        split = ""
        if name == "mlp_bwd":
            rec[name].update({k: sum(r[k] for r in in_step)
                              for k in ("kernel_ms", "reduce_ms")})
            split = (f" = kernel {rec[name]['kernel_ms']:.4f} + dW reduction "
                     f"{rec[name]['reduce_ms']:.4f}")
        log(f"  {name}, one training step's {len(in_step)} calls: kernel "
            f"{rec[name]['ms']:.4f} ms{split}  plain "
            f"{rec[name]['plain_ms']:.4f}  library "
            f"{rec[name]['library_ms']:.4f}  bound "
            f"{rec[name]['bound_ms']:.4f} ms ({rec[name]['bound_by']})")
    kernels.reset_launches()  # the comparisons above are not the main path


@torch.no_grad()
def check_gather(device):
    """Phase 3, row gather: dma_gather against torch.index_select at the
    benchmark's shapes, bit-equal (a copy) at every row width."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
    for f, dtype in bg.ROW_WIDTHS:
        table, idx = bg.gather_inputs(bg.T_ROWS, bg.M_ROWS, f, dtype, device)
        assert torch.equal(bg.dma_gather(table, idx),
                           bg.dma_gather_plain(table, idx)), (f, dtype)
        log(f"  dma_gather {dtype} F={f} [{bg.T_ROWS}] x {bg.M_ROWS}: "
            f"bit-equal to index_select")
    kernels.reset_launches()  # the comparisons above are not the main path


def gather_phase(rec):
    """Phase 6: the gather benchmark's entry point, counts zeroed before and
    read after. The record is its 256-byte rows (bf16 F = 128), with the
    faster of index_select and table[idx] as library_ms; every width goes to
    chip_smoke.json."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
    kernels.reset_launches()
    rows = bg.main([])
    launches = kernels.LAUNCHES["dma_gather"]
    assert launches > 0 and all(r["equal"] for r in rows)
    for r in rows:
        # indices read once, rows written once, each distinct row read once
        r["bytes"] = r["m"] * (4 + r["row_bytes"]) \
            + r["distinct_rows"] * r["row_bytes"]
        r["bound_ms"] = bound_ms(r["bytes"], 0)
        r["bound_ns_per_row"] = r["bound_ms"] * 1e6 / r["m"]
        log(f"  row {r['row_bytes']} B: bound {r['bound_ns_per_row']:.4f} "
            f"ns/row ({r['distinct_rows']} distinct rows)")
    wide = rows[-1]
    rec["dma_gather"] = dict(
        name="dma_gather", route="cuda",
        source="ucsa_neural_rendering_tpu_torch/csrc/dma_gather.cu",
        replaces="scripts/bench_dma_gather.py:156", launches=launches,
        max_abs_err=0.0, ms=wide["ms"], plain_ms=wide["index_select_ms"],
        bound_ms=wide["bound_ms"], bound_by="bytes",
        library_ms=min(wide["index_select_ms"], wide["index_ms"]),
        widths=rows)
    return launches


# ------------------------------------------------------------- main path
def timed(fn):
    """(fn(), its host ms), the clock read after synchronising the card
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def fresh_frame(tr, pose, rays, grid):
    """tr.render_image of one frame whose packed table is packed anew, as
    a joint step's test render after a NeRF update repacks it (the card's
    default: fp8 rows at 2^23): the pack counts in the frame, and the plain
    path packs with its own plain version."""
    tr._packed_cache.clear()
    return tr.render_image(None, pose, INTRINSICS, rays, grid)


def render_phase(model, grid, cfgs, device, frames):
    """Phase 4: full-frame renders through NeRFTrainer.render_image, each
    packing its table anew (fresh_frame): the kernel path, the same frames
    with only the MLP kernels plain (timed only), then the plain path (held
    to the kernel path)."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    H, W = 240, 320
    poses = [look_at(POSES[i % len(POSES)]) for i in range(frames)]
    rays = [get_rays(p, INTRINSICS, H, W, device=device) for p in poses]
    trainers = {name: NeRFTrainer(model, cfg, image_hw=(H, W), device=device)
                for name, cfg in cfgs.items()}
    # warm-up frame per config (allocator, cuBLAS handles): not counted
    for tr in trainers.values():
        tr.render_image(None, poses[0], INTRINSICS, rays[0], grid)
    torch.cuda.synchronize()

    # the kernel path and, for its frame time, the same frames with only
    # the MLP kernels plain (torch.matmul chains), in turns (kernel, MLP
    # plain, MLP plain, kernel, ...) so that drifts of the host's speed
    # within the call fall on both; the counts are zeroed just before each
    # kernel-path frame and read just after
    outs, frame_ms, mlp_plain_ms, per_cfg = {}, {}, {}, {}
    for name, tr in trainers.items():
        frame_ms[name], mlp_plain_ms[name] = [], []
        per_cfg[name] = dict.fromkeys(kernels.LAUNCHES, 0)
        for i in range(frames):
            frame = lambda: fresh_frame(tr, poses[i], rays[i], grid)
            for kernel_path in ((True, False) if i % 2 == 0 else
                                (False, True)):
                if kernel_path:
                    kernels.reset_launches()
                    outs[name, i], ms = timed(frame)
                    for k, v in kernels.LAUNCHES.items():
                        per_cfg[name][k] += v
                    frame_ms[name].append(ms)
                else:
                    kernels.reset_launches()
                    with kernels.plain_versions(*MLP_KERNELS):
                        mlp_plain_ms[name].append(timed(frame)[1])
                    assert kernels.LAUNCHES["mlp_fwd"] == 0, kernels.LAUNCHES
    launches = {k: sum(c[k] for c in per_cfg.values())
                for k in kernels.LAUNCHES}

    results = {}
    kernels.reset_launches()
    for name, tr in trainers.items():
        plain_times, agree = [], []
        for i in range(frames):
            with kernels.plain_versions():
                ref, ms = timed(lambda: fresh_frame(tr, poses[i], rays[i],
                                                    grid))
            plain_times.append(ms)
            out = outs[name, i]
            assert out["nerf_rgb"].shape == (H, W, 3)
            assert out["nerf_semantics_raw"].shape == (H, W,
                                                       model.num_semantic_classes)
            for k in ("nerf_rgb", "nerf_semantics_raw", "nerf_depth"):
                assert torch.isfinite(out[k]).all(), k
            rgb_d = (out["nerf_rgb"] - ref["nerf_rgb"]).abs()
            dep_d = (out["nerf_depth"] - ref["nerf_depth"]).abs()
            labels = (out["nerf_semantics"] == ref["nerf_semantics"]
                      ).float().mean().item()
            agree.append(dict(rgb_max=rgb_d.max().item(),
                              rgb_mean=rgb_d.mean().item(),
                              depth_max=dep_d.max().item(),
                              depth_mean=dep_d.mean().item(),
                              labels=labels))
        per_frame = {k: v / frames for k, v in per_cfg[name].items() if v}
        results[name] = dict(ms_per_frame=frame_ms[name],
                             mlp_plain_ms_per_frame=mlp_plain_ms[name],
                             plain_ms_per_frame=plain_times,
                             launches=per_cfg[name],
                             launches_per_frame=per_frame, agreement=agree)
        log(f"  {name}: ms/frame kernel {[round(t, 2) for t in frame_ms[name]]}"
            f" MLP kernels plain {[round(t, 2) for t in mlp_plain_ms[name]]}"
            f" plain {[round(t, 2) for t in plain_times]}")
        log(f"  {name}: launches per frame {per_frame}")
        for i, a in enumerate(agree):
            log(f"  {name} frame {i}: " + " ".join(
                f"{k} {v:.3e}" for k, v in a.items()))
            # kernel vs plain on the card: the same arithmetic up to f32
            # summation order, bf16 matmul tiling and near-tie decisions
            # (top-K, w > 1e-4 mask, inverse-CDF bins) on a few rays
            assert a["labels"] >= 0.99, a
            assert a["rgb_mean"] <= 1e-3 and a["depth_mean"] <= 1e-2, a
    # the reference renders ran no kernel
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    return launches, results, trainers, outs


def _level_sums(grad, spec):
    """Per level: the [F] sums of the table gradient and its L1 mass."""
    sums, mass = [], []
    for lvl in range(spec.n_levels):
        rows = grad[spec.offsets[lvl]:spec.offsets[lvl] + spec.sizes[lvl]]
        sums.append(rows.double().sum(0))
        mass.append(rows.double().abs().sum())
    return torch.stack(sums), torch.stack(mass)


def sum_err(a, b):
    """max over levels of max |Δ per-feature sum| / the level's mass, of
    two _level_sums results (b the reference)"""
    return ((a[0] - b[0]).abs().amax(-1) / b[1]).max().item()


def loss_err(a, b):
    """max relative difference of two steps' loss parts (b the reference)"""
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in a)


def train_phase(targets, device, steps, seed, out_dir):
    """Phase 5: `steps` NeRFTrainer.train_steps of a fresh shipped-config
    model on the kernel path, then with only the MLP kernels plain, then on
    the plain path, each from the same init and generator seed;
    update_occupancy after every 16th step."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    intr = torch.tensor(INTRINSICS, device=device)
    batches = [{"pose": torch.as_tensor(look_at(POSES[i % len(POSES)]),
                                        device=device),
                "intrinsics": intr, "image": out["nerf_rgb"],
                "label": out["nerf_semantics"], "depth": out["nerf_depth"],
                "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
               for i, out in enumerate(targets)]

    def make_trainer(render_cfg, stochastic_fwd=False):
        """A fresh model's trainer; render_cfg None takes the trainer's
        default RenderConfig()."""
        model = SemanticNeRF(**TRAIN_MODEL, device=device,
                             generator=torch.Generator().manual_seed(seed),
                             stochastic_fwd=stochastic_fwd)
        tr = NeRFTrainer(model, render_cfg, n_rays=N_RAYS,
                         image_hw=(240, 320), device=device)
        tr.init()
        return tr

    def run(tr, res, n_steps=steps, plain=None):
        """Steps tr n_steps times (update_occupancy after every 16th), one
        step and its refresh per next(), inside kernels.plain_versions(
        *plain) when plain is given (() swaps every kernel), filling res:
        losses, host ms, step 1's level sums, and the launches of the steps
        and of the refreshes (counts zeroed just before each, read just
        after)."""
        ctx = (contextlib.nullcontext if plain is None
               else lambda: kernels.plain_versions(*plain))
        gen = torch.Generator(device).manual_seed(seed + 1)
        grid = tr.init_occupancy()
        res.update(losses=[], step_ms=[], refresh_ms=[],
                   launches=dict.fromkeys(kernels.LAUNCHES, 0),
                   refresh_launches=dict.fromkeys(kernels.LAUNCHES, 0))
        for i in range(n_steps):
            with ctx():
                kernels.reset_launches()
                parts, ms = timed(lambda: tr.train_step(
                    batches[i % len(batches)], gen, grid))
                for k, v in kernels.LAUNCHES.items():
                    res["launches"][k] += v
                res["step_ms"].append(ms)
                if (i + 1) % tr.occ_cfg.update_every == 0:
                    kernels.reset_launches()
                    grid, ms = timed(lambda: tr.update_occupancy(grid, gen))
                    for k, v in kernels.LAUNCHES.items():
                        res["refresh_launches"][k] += v
                    res["refresh_ms"].append(ms)
            if i == 0:
                res["sums"] = _level_sums(tr.model.encoder.table.grad,
                                          tr.model.encoder.spec)
            res["losses"].append({k: v.item() for k, v in parts.items()})
            res.update(grid=grid, gen=gen)
            yield

    def drive(*runs):
        """Advance the runs in turns, one step each, to their ends."""
        for _ in itertools.zip_longest(*runs):
            pass

    def k9_run(label):
        """K9_STEPS shipped steps of SemanticNeRF(stochastic_fwd=mode) at
        train_packed_max_entries budget (K9_RUNS[label]) on the kernel path
        in turns with the plain path, then step 1 once more
        with the plain versions of the table and compositing kernels only
        (K9_PLAIN: the placements and the MLPs stay kernels, so every
        sample lands on the kernel path's x01 bits); held to the step-1
        limits and the falling loss. Under a stochastic forward a point
        whose position differs in its last bits draws another corner: the
        share of step 1's x01 rows with the same bits as on the kernel
        path is measured beside the level sums."""
        mode, budget = K9_RUNS[label]
        enc_kernel = K9_ENCODES[label]
        packs = int(mode is not True and budget > 0)
        cfg = replace(shipped, train_packed_max_entries=budget)
        trainers = [make_trainer(cfg, mode) for _ in range(3)]
        x01s = []
        for t in trainers:
            x01s.append([])
            t.model.encoder.register_forward_hook(
                lambda m, a, kw, out, rows=x01s[-1]: rows.append(a[0].clone())
                if kw.get("train") and len(rows) < 2 else None,
                with_kwargs=True)
        kern_k9, plain_k9, placed = {}, {}, {}
        drive(run(trainers[0], kern_k9, K9_STEPS),
              run(trainers[1], plain_k9, K9_STEPS, plain=()))
        drive(run(trainers[2], placed, 1, plain=K9_PLAIN))
        assert not any(plain_k9["launches"].values()), plain_k9["launches"]
        per_step = {k: v / K9_STEPS for k, v in kern_k9["launches"].items()
                    if v}
        # the run's encode, 2 a step (coarse and fine), and no other
        # forward encode of a step; a repack a step where the encode reads
        # one; the backward in the mode's own draw
        encodes = ("hash_encode_fwd", "hash_encode_face_fwd",
                   "hash_encode_packed_fwd")
        assert not any(per_step.get(k, 0) for k in encodes
                       if k != enc_kernel), per_step
        assert per_step[enc_kernel] == 2, per_step
        assert per_step.get("pack_table", 0) == packs, per_step
        assert per_step["hash_encode_bwd"] == 2, per_step
        for s in kern_k9["losses"] + plain_k9["losses"] + placed["losses"]:
            assert all(math.isfinite(v) for v in s.values()), s
        same = [(a == b).all(-1) for a, b in zip(x01s[0], x01s[1])]
        share = torch.cat(same).float().mean().item()
        same_placed = all(torch.equal(a, b) for a, b in zip(x01s[0],
                                                             x01s[2]))
        total = [s["loss_nerf_total"] for s in kern_k9["losses"]]
        res = dict(
            ms_per_step=kern_k9["step_ms"],
            plain_ms_per_step=plain_k9["step_ms"],
            median_ms_per_step=statistics.median(kern_k9["step_ms"]),
            plain_median_ms_per_step=statistics.median(plain_k9["step_ms"]),
            ms_per_refresh=kern_k9["refresh_ms"],
            launches_per_step=per_step,
            refresh_launches=kern_k9["refresh_launches"],
            launches={k: v + kern_k9["refresh_launches"][k]
                      for k, v in kern_k9["launches"].items()},
            losses=kern_k9["losses"], plain_losses=plain_k9["losses"],
            step1_loss_rel_err=loss_err(kern_k9["losses"][0],
                                        plain_k9["losses"][0]),
            step1_level_sum_err=sum_err(kern_k9["sums"], plain_k9["sums"]),
            step1_x01_same_bits_share=share,
            step1_loss_rel_err_placed=loss_err(kern_k9["losses"][0],
                                               placed["losses"][0]),
            step1_level_sum_err_placed=sum_err(kern_k9["sums"],
                                               placed["sums"]),
            last8_mean_loss=sum(total[-8:]) / 8)
        log(f"  stochastic_fwd={mode!r}, train packing {budget}: ms/step "
            f"kernel median "
            f"{res['median_ms_per_step']:.2f} plain median "
            f"{res['plain_median_ms_per_step']:.2f}; launches per step "
            f"{per_step}")
        log(f"  {label} step 1 against the plain path: "
            f"losses max rel diff {res['step1_loss_rel_err']:.3e}, level "
            f"sums {res['step1_level_sum_err']:.3e} of the mass, x01 rows "
            f"with the same bits {share:.4f}; against the plain table and "
            f"compositing kernels (the same x01: {same_placed}): losses "
            f"{res['step1_loss_rel_err_placed']:.3e}, level sums "
            f"{res['step1_level_sum_err_placed']:.3e}; total loss step 1 "
            f"{total[0]:.5f}, mean of the last 8 {res['last8_mean_loss']:.5f}")
        assert same_placed
        assert res["step1_loss_rel_err"] <= 2e-3, res["step1_loss_rel_err"]
        assert res["step1_loss_rel_err_placed"] <= 2e-3
        assert res["step1_level_sum_err_placed"] <= 5e-4
        assert res["last8_mean_loss"] < total[0], (total[0],
                                                   res["last8_mean_loss"])
        return res

    # the kernel path and, in turns with it, the same steps with only the
    # MLP kernels plain (torch.matmul chains and their step-by-step
    # backward): what the MLP kernels contribute to the agreement and to
    # the step time
    # and the same steps unpacked (train_packed_max_entries 0: the
    # supported configuration that encodes with hash_encode_fwd)
    shipped = train_config()
    tr = make_trainer(shipped)
    kern, mlp_plain, unpacked = {}, {}, {}
    drive(run(tr, kern), run(make_trainer(shipped), mlp_plain,
                             plain=MLP_KERNELS),
          run(make_trainer(replace(shipped, train_packed_max_entries=0)),
              unpacked))
    in_refresh = kern["refresh_launches"]
    launches = {k: v + in_refresh[k] for k, v in kern["launches"].items()}
    # every kernel but the gather benchmark's, the unpacked exact and face
    # encodes (a step on the card encodes through its repack: one
    # pack_table and two hash_encode_packed_fwd a step) and the no-grid
    # placement
    idle = ("dma_gather", "hash_encode_face_fwd", "stratified_placement",
            "hash_encode_fwd")
    missing = [k for k, v in launches.items() if v <= 0 and k not in idle]
    assert not missing, f"kernels not launched on the training path: {missing}"
    assert not any(launches[k] for k in idle[1:]), launches
    assert kern["launches"]["pack_table"] == steps and \
        kern["launches"]["hash_encode_packed_fwd"] == 2 * steps, launches
    assert in_refresh["mlp_fwd"] > 0 and in_refresh["hash_encode_sampled"] > 0
    assert launches["mlp_bwd"] > 0 and in_refresh["mlp_bwd"] == 0
    assert not any(mlp_plain["launches"][k] + mlp_plain["refresh_launches"][k]
                   for k in MLP_KERNELS), mlp_plain
    # unpacked: hash_encode_fwd 2 a step, no pack; step 1 the packed
    # step's losses and its table gradient bit for bit (phase 14 (c)); the
    # loss falls
    u = unpacked["launches"]
    assert u["hash_encode_fwd"] == 2 * steps and not u["pack_table"] and \
        not u["hash_encode_packed_fwd"], u
    for k, v in u.items():
        launches[k] += v + unpacked["refresh_launches"][k]
    err_unpacked = loss_err(kern["losses"][0], unpacked["losses"][0])
    sums_unpacked = sum_err(kern["sums"], unpacked["sums"])
    total_u = [s["loss_nerf_total"] for s in unpacked["losses"]]
    for s in unpacked["losses"]:
        assert all(math.isfinite(v) for v in s.values()), s
    log(f"  unpacked (train_packed_max_entries 0), in turns: ms/step median "
        f"{statistics.median(unpacked['step_ms']):.2f} against the packed "
        f"{statistics.median(kern['step_ms']):.2f}; step 1 losses against "
        f"the packed step {err_unpacked:.3e}, level sums {sums_unpacked:.3e}"
        f"; total loss {total_u[0]:.5f} → mean of the last 8 "
        f"{sum(total_u[-8:]) / 8:.5f}")
    assert err_unpacked == 0 and sums_unpacked == 0, (err_unpacked,
                                                      sums_unpacked)
    assert sum(total_u[-8:]) / 8 < total_u[0], total_u

    # step 1 once more with only the two backward kernels' plain versions:
    # the same forward bit for bit, so the table gradient differs by
    # composite_bwd's scan and index_add_'s atomics on the card alone
    bwd_plain, plain = {}, {}
    drive(run(make_trainer(shipped), bwd_plain, 1,
              plain=("hash_encode_bwd", "composite_bwd")))
    drive(run(make_trainer(shipped), plain, plain=()))
    assert not any(plain["launches"].values()), plain["launches"]
    assert not any(plain["refresh_launches"].values())

    total = [s["loss_nerf_total"] for s in kern["losses"]]
    first_k, first_p = kern["losses"][0], plain["losses"][0]
    err_loss = loss_err(first_k, first_p)
    err_loss_mlp = loss_err(first_k, mlp_plain["losses"][0])
    err_plain = sum_err(kern["sums"], plain["sums"])
    err_bwd = sum_err(kern["sums"], bwd_plain["sums"])
    err_mlp = sum_err(kern["sums"], mlp_plain["sums"])
    last8 = sum(total[-8:]) / 8
    log(f"  step 1 losses kernel {first_k} plain {first_p}: max rel diff "
        f"{err_loss:.3e} (against MLP kernels plain only {err_loss_mlp:.3e})")
    log(f"  step 1 per-level gradient sums, max |diff| / level mass: "
        f"against the plain path {err_plain:.3e}, against plain backward "
        f"kernels only {err_bwd:.3e}, against plain MLP kernels only "
        f"{err_mlp:.3e}")
    log(f"  total loss step 1 {total[0]:.5f}, mean of the last 8 steps "
        f"{last8:.5f}; every 4th step {[round(t, 5) for t in total[::4]]}")
    for s in kern["losses"] + mlp_plain["losses"] + plain["losses"]:
        assert all(math.isfinite(v) for v in s.values()), s
    # step 1, the same parameters and draws: the paths differ only in
    # summation order (placement, compositing, the MLPs' products, the
    # plain table backward's atomics). With only the MLP kernels plain the paths run the same
    # kernels but the MLPs, which differ from cuBLAS by a bf16 ulp on ~1e-4
    # of the elements: 1e-5 (readings 0 on the loss, 1.9e-7 on the level
    # sums).
    assert err_loss <= 2e-3 and err_loss_mlp <= 1e-5, (err_loss, err_loss_mlp)
    # per level, the table gradient's sums do not depend on which corner a
    # point's last position bits draw. Against the plain path: within 5e-4
    # of the level's L1 mass — the placements' inverse CDFs sum in another
    # order and move some samples by up to ~3e-4 scene units, a third of
    # the finest cell (8 / 8192), which changes those points' features and
    # so their cotangents. With only the backward kernels plain, or only
    # the MLP kernels: 1e-5 (a summation order, or an MLP ulp; a 1e-5
    # change of d sigma flips a bf16 rounding of the cotangent on a few
    # elements).
    assert err_plain <= 5e-4, err_plain
    assert err_mlp <= 1e-5, err_mlp
    assert err_bwd <= 1e-5, err_bwd
    assert last8 < total[0], (total[0], last8)

    # the trainer's default RenderConfig() (256 coarse + 256 fine samples a
    # ray, so composite_bwd runs over 512): a few steps
    # on the kernel path in turns with the plain path, from the same init
    # and draws, held to the step-1 limits above
    dflt, dflt_plain = {}, {}
    drive(run(make_trainer(None), dflt, DEFAULT_CFG_STEPS),
          run(make_trainer(None), dflt_plain, DEFAULT_CFG_STEPS, plain=()))
    missing = [k for k, v in dflt["launches"].items()
               if v <= 0 and k not in ("dma_gather", "occ_grid_update",
                                       "hash_encode_sampled",
                                       "hash_encode_face_fwd",
                                       "stratified_placement",
                                       "hash_encode_fwd")]
    assert not missing, f"default config: kernels not launched: {missing}"
    assert not any(dflt_plain["launches"].values()), dflt_plain["launches"]
    for s in dflt["losses"] + dflt_plain["losses"]:
        assert all(math.isfinite(v) for v in s.values()), s
    dflt_loss = loss_err(dflt["losses"][0], dflt_plain["losses"][0])
    dflt_sums = sum_err(dflt["sums"], dflt_plain["sums"])
    log(f"  default RenderConfig() (256 + 256 samples), {DEFAULT_CFG_STEPS} "
        f"steps: step 1 losses max rel diff {dflt_loss:.3e}, level sums "
        f"{dflt_sums:.3e}; ms/step kernel "
        f"{[round(t, 2) for t in dflt['step_ms']]} plain "
        f"{[round(t, 2) for t in dflt_plain['step_ms']]}")
    assert dflt_loss <= 2e-3 and dflt_sums <= 5e-4, (dflt_loss, dflt_sums)

    # the K9 training encoders on the shipped step: K9_STEPS steps of
    # stochastic_fwd True, "face" and "fine" on the kernel path in turns
    # with the plain path, from the same init and draws ("face" and "fine"
    # are phase 14 (d): the hybrids through the step's packed table), and
    # of "face" unpacked (hash_encode_face_fwd)
    k9 = {label: k9_run(label) for label in K9_RUNS}
    for res in k9.values():
        for k, v in res["launches"].items():
            launches[k] += v

    n_refresh = len(kern["refresh_ms"])
    per_step = {k: v / steps for k, v in kern["launches"].items() if v}
    per_refresh = {k: v / n_refresh for k, v in in_refresh.items() if v}
    med = statistics.median(kern["step_ms"])
    med_mlp = statistics.median(mlp_plain["step_ms"])
    log(f"  ms/step kernel median {med:.2f} (all {[round(t, 2) for t in kern['step_ms']]})")
    log(f"  ms/step MLP kernels plain median {med_mlp:.2f}; plain median "
        f"{statistics.median(plain['step_ms']):.2f}")
    log(f"  rays/s {N_RAYS / med * 1e3:.1f} (MLP kernels plain "
        f"{N_RAYS / med_mlp * 1e3:.1f}); ms/refresh kernel "
        f"{[round(t, 2) for t in kern['refresh_ms']]} MLP kernels plain "
        f"{[round(t, 2) for t in mlp_plain['refresh_ms']]} plain "
        f"{[round(t, 2) for t in plain['refresh_ms']]}")
    log(f"  launches per step {per_step}; per refresh {per_refresh}")

    step_fn = lambda: tr.train_step(batches[0], kern["gen"], kern["grid"])
    table, busy = profile_run(step_fn, out_dir, "profile_train_step.txt")
    log("\n".join(table.splitlines()[:16]))
    busy["idle_share_unprofiled"] = 1.0 - busy["device_busy_ms"] / med
    with kernels.plain_versions(*MLP_KERNELS):
        _, busy_mlp = profile_run(step_fn, out_dir,
                                  "profile_train_step_mlp_plain.txt")
    log(f"  profiled train step: wall {busy['wall_ms']:.2f} ms, device busy "
        f"{busy['device_busy_ms']:.2f} ms, idle share {busy['idle_share']:.3f}"
        f" (against the median unprofiled step "
        f"{busy['idle_share_unprofiled']:.3f}); device-timeline spans, not "
        f"counted: {busy['annotations']}")
    log(f"  device operations per train step: {busy['device_ops']} "
        f"(busy {busy['device_busy_ms']:.3f} ms); with the MLP kernels plain "
        f"{busy_mlp['device_ops']} (busy {busy_mlp['device_busy_ms']:.3f} "
        f"ms)")
    log("  kernels' device ms in the profiled train step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in busy["kernel_ms"].items()))
    result = dict(
        ms_per_step=kern["step_ms"], plain_ms_per_step=plain["step_ms"],
        mlp_plain_ms_per_step=mlp_plain["step_ms"],
        median_ms_per_step=med, rays_per_s=N_RAYS / med * 1e3,
        median_ms_per_step_mlp_plain=med_mlp,
        ms_per_refresh=kern["refresh_ms"],
        mlp_plain_ms_per_refresh=mlp_plain["refresh_ms"],
        plain_ms_per_refresh=plain["refresh_ms"],
        launches=launches, launches_per_step=per_step,
        launches_per_refresh=per_refresh, losses=kern["losses"],
        mlp_plain_losses=mlp_plain["losses"],
        plain_losses=plain["losses"], step1_loss_rel_err=err_loss,
        step1_loss_rel_err_mlp=err_loss_mlp,
        step1_level_sum_err=err_plain, step1_level_sum_err_bwd=err_bwd,
        step1_level_sum_err_mlp=err_mlp,
        profiled_step=busy, profiled_step_mlp_plain=busy_mlp,
        default_cfg=dict(ms_per_step=dflt["step_ms"],
                         plain_ms_per_step=dflt_plain["step_ms"],
                         losses=dflt["losses"],
                         plain_losses=dflt_plain["losses"],
                         step1_loss_rel_err=dflt_loss,
                         step1_level_sum_err=dflt_sums,
                         launches=dflt["launches"]),
        unpacked=dict(ms_per_step=unpacked["step_ms"],
                      ms_per_refresh=unpacked["refresh_ms"],
                      losses=unpacked["losses"],
                      launches=unpacked["launches"],
                      step1_loss_rel_err=err_unpacked,
                      step1_level_sum_err=sums_unpacked),
        stochastic_fwd=k9)
    return launches, result


# -------------------------------------------------------------- segmentation
SEG_BATCH = 4  # the reference's pretrain and joint batch
SEG_HW = (240, 320)  # the shipped image size
SEG_CLASSES = 40
SEG_STEPS = 10
SEG_EVAL_CALLS = 12  # timed eval forwards a precision, after the warm-up
SEG_LR = 1e-4  # Adam, cfg/exp/pretrain_scannet_25k_deeplabv3.yml
TF32_OPS_PER_S = 495e12  # dense, on the tensor cores
# the TF32 forward against the f32 one: logits max |Δ| over their largest
# magnitude, and the share of equal labels (set before the first run)
TF32_LOGITS_REL, TF32_LABELS = 5e-2, 0.95


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True) inside the block: an op
    without a deterministic form raises (new memory is not filled, as it
    would be by default). cuBLAS needs CUBLAS_WORKSPACE_CONFIG set before
    CUDA starts: main sets it."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


@contextlib.contextmanager
def tf32(on):
    """cuDNN's and cuBLAS's TF32 for f32 convolutions and products, on or
    off inside the block (global flags: set here, put back after)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _taps(n_in, n_out, k, stride, pad, dil):
    """Kernel taps of one axis, summed over its output positions, that land
    inside the input (not on the zero padding)."""
    return sum(0 <= o * stride - pad + j * dil < n_in
               for o in range(n_out) for j in range(k))


def conv_macs(model, x):
    """Multiply-adds of the model's convolutions on x: (forward, step). Only
    kernel taps inside the input count (the ASPP's rate-24 and -36 taps fall
    mostly on the padding of a 30 × 40 map). A step is the forward, the
    weight gradients (as many) and the data gradients (as many, less the
    stem's: the images take none)."""
    per_conv = []

    def hook(m, inp, out):
        n, c_in, h, w = inp[0].shape
        taps = _taps(h, out.shape[2], m.kernel_size[0], m.stride[0],
                     m.padding[0], m.dilation[0]) \
            * _taps(w, out.shape[3], m.kernel_size[1], m.stride[1],
                    m.padding[1], m.dilation[1])
        per_conv.append(n * m.out_channels * c_in // m.groups * taps)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in handles:
            h.remove()
    fwd = sum(per_conv)
    return fwd, 3 * fwd - per_conv[0]


def seg_batch(seed, batch, device):
    """Images U(0, 1) [B, 240, 320, 3] and labels [B, 240, 320]: a class in
    0..39 on each 16 × 16 block, a fifth of the blocks -1, from seed."""
    g = torch.Generator().manual_seed(seed)
    images = torch.rand((batch, *SEG_HW, 3), generator=g)
    blocks = (batch, SEG_HW[0] // 16, SEG_HW[1] // 16)
    labels = torch.randint(0, SEG_CLASSES, blocks, generator=g)
    labels[torch.rand(blocks, generator=g) < 0.2] = -1
    labels = labels.repeat_interleave(16, 1).repeat_interleave(16, 2)
    return images.to(device), labels.to(device)


def rel(a, b):
    """max |a − b| over max |b| (a moved to b's device)."""
    return float((a.to(b.device) - b).abs().max() / b.abs().max())


def seg_phase(device, seed, out_dir):
    """Phase 7: DeepLabV3-ResNet101 (full width, 40 classes, seeded init)
    through SegTrainer: the card against the CPU at batch 1 (eval forward,
    BN trick, train step 1; TF32 off), then 10 Adam steps at batch 4 with
    TF32 off and on in turns, the eval forward timed both ways, profiles,
    peak memory, the confusion matrix and the convolutions' bounds."""
    import numpy as np

    from ucsa_neural_rendering_tpu_torch.models import DeepLabV3
    from ucsa_neural_rendering_tpu_torch.train import SegTrainer

    cpu = torch.device("cpu")

    def make(dev, dtype=torch.float32):
        model = DeepLabV3(num_classes=SEG_CLASSES, device=dev,
                          generator=torch.Generator().manual_seed(seed))
        tr = SegTrainer(model.to(dtype), {"name": "Adam", "lr": SEG_LR},
                        device=dev)
        tr.init()
        return tr

    res = {"batch": SEG_BATCH, "image_hw": list(SEG_HW),
           "classes": SEG_CLASSES, "optimizer": f"Adam lr {SEG_LR}"}

    # the card against the CPU at batch 1, TF32 off (phase 1 set it off),
    # from the same seeded weights; the CPU's dropout generator is shared
    x1, y1 = seg_batch(seed, 1, cpu)
    card, host = make(device), make(cpu)
    _, lc = card.eval_step(x1)
    t0 = time.perf_counter()
    _, lh = host.eval_step(x1)
    cpu_eval_s = time.perf_counter() - t0
    check = {"eval_logits_rel": rel(lc, lh),
             "eval_labels_equal": float((lc.argmax(1).cpu() == lh.argmax(1))
                                        .float().mean())}
    card.infer(x1, update_bn=True)
    host.infer(x1, update_bn=True)
    hs = host.model.state_dict()
    check["bn_trick_stats_rel"] = max(
        rel(v, hs[k]) for k, v in card.model.state_dict().items()
        if "running" in k)
    # train step 1 from the same state (the CPU's, BN trick included), on
    # the card, on the CPU, and on the CPU in f64 (logits and loss in f32,
    # as the model computes them). In train mode a fresh R101 amplifies f32
    # rounding from the forward into the first layers' gradients, so any
    # two f32 steps differ by per cents of the gradient's norm, and Adam's
    # first update (sign-like, g / (|g| + eps)) by more. So the card's step
    # is held to the f64 one no further than twice the CPU's f32 step is,
    # and to the CPU's loss within 1e-4; the per-parameter update agreement
    # is reported
    card.model.load_state_dict(hs)
    host64 = make(cpu, torch.float64)
    host64.model.load_state_dict(hs)

    def step(tr, x):
        """(loss, gradient, update), the last two flat f64 CPU tensors in
        named_parameters order."""
        before = [p.detach().clone() for p in tr.model.parameters()]
        loss, _ = tr.train_step(x, y1, SEG_LR,
                                torch.Generator().manual_seed(seed + 1))
        flat = lambda ts: torch.cat([t.detach().double().cpu().reshape(-1)
                                     for t in ts])
        ps = list(tr.model.parameters())
        return (float(loss), flat(p.grad for p in ps),
                flat(p.detach() - b for p, b in zip(ps, before)))

    loss_c, g_c, u_c = step(card, x1)
    t0 = time.perf_counter()
    loss_h, g_h, u_h = step(host, x1)
    cpu_step_s = time.perf_counter() - t0
    loss_64, g_64, u_64 = step(host64, x1.double())
    check["step_loss_rel"] = abs(loss_c / loss_h - 1)
    for name, c, h, e in (("grad", g_c, g_h, g_64), ("update", u_c, u_h,
                                                      u_64)):
        check[f"step_{name}_card_to_f64"] = float((c - e).norm() / e.norm())
        check[f"step_{name}_cpu_to_f64"] = float((h - e).norm() / e.norm())
    upd, i = {}, 0
    for k, p in host.model.named_parameters():
        n = p.numel()
        du_c, du_h = u_c[i:i + n], u_h[i:i + n]
        upd[k] = float((du_c - du_h).norm()) / max(float(du_h.norm()),
                                                   1e-30)
        i += n
    worst = max(upd, key=upd.get)
    check.update(step_update_rel=upd[worst], step_update_worst=worst,
                 cpu_eval_s=cpu_eval_s, cpu_step_s=cpu_step_s)
    log(f"  card against CPU, batch 1, TF32 off: eval logits "
        f"{check['eval_logits_rel']:.2e} of max (limit 1e-4), labels equal "
        f"{check['eval_labels_equal']:.5f} (limit 0.999); BN-trick running "
        f"stats {check['bn_trick_stats_rel']:.2e} (limit 1e-4); step 1 loss "
        f"{loss_c:.6f} / {loss_h:.6f} (f64 {loss_64:.6f}), "
        f"{check['step_loss_rel']:.2e} (limit 1e-4); against the f64 step, "
        f"card / CPU: gradient {check['step_grad_card_to_f64']:.2e} / "
        f"{check['step_grad_cpu_to_f64']:.2e}, update "
        f"{check['step_update_card_to_f64']:.2e} / "
        f"{check['step_update_cpu_to_f64']:.2e} of its norm (limit: the "
        f"card's within 2x the CPU's); card against CPU, updates "
        f"{upd[worst]:.2e} of their norm at worst ({worst}); CPU eval "
        f"{cpu_eval_s:.1f} s, f32 step {cpu_step_s:.1f} s")
    assert check["eval_logits_rel"] <= 1e-4, check
    assert check["eval_labels_equal"] >= 0.999, check
    assert check["bn_trick_stats_rel"] <= 1e-4, check
    assert check["step_loss_rel"] <= 1e-4, check
    for name in ("grad", "update"):
        assert check[f"step_{name}_card_to_f64"] <= \
            2 * check[f"step_{name}_cpu_to_f64"], check
    res["card_against_cpu"] = check
    del card, host, host64

    # batch 4: SEG_STEPS Adam steps with TF32 off and on, in turns, from the
    # same init and dropout seed; cudnn.benchmark picks each conv's
    # algorithm on its first call (set for this phase only)
    torch.backends.cudnn.benchmark = True
    x, y = seg_batch(seed + 2, SEG_BATCH, device)
    trainers = {on: make(device) for on in (False, True)}
    res["params"] = sum(p.numel() for p in trainers[False].model.parameters())
    fwd_macs, step_macs = conv_macs(trainers[False].model,
                                    x.permute(0, 3, 1, 2).contiguous())
    gens = {on: torch.Generator(device).manual_seed(seed + 3)
            for on in (False, True)}
    losses = {False: [], True: []}
    step_ms = {False: [], True: []}
    preds = []
    hook = trainers[False].model.register_forward_hook(
        lambda m, inp, out: preds.append(out["out"].detach().argmax(1)))
    for i in range(SEG_STEPS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with tf32(on):
                (loss, conf), ms = timed(lambda: trainers[on].train_step(
                    x, y, SEG_LR, gens[on]))
            losses[on].append(float(loss))
            step_ms[on].append(ms)
            if not on:
                last_conf = conf
    hook.remove()
    # the last step's confusion matrix against numpy on its preds
    p, t = preds[-1].cpu().numpy().ravel(), y.cpu().numpy().ravel()
    valid = (t >= 0) & (t < SEG_CLASSES)
    ref = np.zeros((SEG_CLASSES, SEG_CLASSES), np.int64)
    np.add.at(ref, (t[valid], p[valid]), 1)
    assert np.array_equal(last_conf.cpu().numpy(), ref), "confusion matrix"
    assert int(last_conf.sum()) == int(valid.sum()) > 0
    train = {}
    for on in (False, True):
        ls, ms = losses[on], step_ms[on][1:]  # step 1 runs the benchmark
        train["tf32" if on else "f32"] = dict(
            losses=ls, ms=step_ms[on], ms_median=statistics.median(ms),
            images_per_s=SEG_BATCH / statistics.median(ms) * 1e3)
        log(f"  train TF32 {'on ' if on else 'off'}: loss {ls[0]:.4f} → "
            f"{ls[-1]:.4f} (mean of the last 3 {statistics.mean(ls[-3:]):.4f})"
            f", {statistics.median(ms):.2f} ms a step (median of steps 2–"
            f"{SEG_STEPS}), {SEG_BATCH / statistics.median(ms) * 1e3:.1f} "
            f"images/s")
        assert statistics.mean(ls[-3:]) < ls[0], (on, ls)
    res["train"] = train
    res["confusion_matrix_exact"] = True

    # the eval forward of the TF32-off trainer's model, both precisions in
    # turns; two warm-up calls each (cudnn.benchmark)
    ev = trainers[False]
    for on in (False, True):
        with tf32(on):
            for _ in range(2):
                ev.eval_step(x)
    eval_ms = {False: [], True: []}
    for i in range(SEG_EVAL_CALLS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with tf32(on):
                _, ms = timed(lambda: ev.eval_step(x))
            eval_ms[on].append(ms)
    with tf32(False):
        _, l32 = ev.eval_step(x)
    with tf32(True):
        _, ltf = ev.eval_step(x)
    agree = {"logits_rel": rel(ltf, l32),
             "labels_equal": float((ltf.argmax(1) == l32.argmax(1)).float()
                                   .mean()),
             "limits": [TF32_LOGITS_REL, TF32_LABELS]}
    evals = {}
    for on in (False, True):
        key = "tf32" if on else "f32"
        with tf32(on):
            table, busy = profile_run(lambda: ev.eval_step(x), out_dir,
                                      f"profile_seg_eval_{key}.txt")
        med = statistics.median(eval_ms[on])
        evals[key] = dict(ms=eval_ms[on], ms_median=med,
                          images_per_s=SEG_BATCH / med * 1e3,
                          profiled=busy)
        log(f"  eval TF32 {'on ' if on else 'off'}: {med:.2f} ms a batch "
            f"(median of {SEG_EVAL_CALLS}), {SEG_BATCH / med * 1e3:.1f} "
            f"images/s; profiled: device busy {busy['device_busy_ms']:.2f} "
            f"ms of {busy['wall_ms']:.2f}, idle share "
            f"{busy['idle_share']:.3f}, {busy['device_ops']} operations")
    log(f"  TF32 forward against f32: logits {agree['logits_rel']:.2e} of "
        f"max (limit {TF32_LOGITS_REL}), labels equal "
        f"{agree['labels_equal']:.4f} (limit {TF32_LABELS})")
    assert agree["logits_rel"] <= TF32_LOGITS_REL, agree
    assert agree["labels_equal"] >= TF32_LABELS, agree
    res["eval"] = evals
    res["tf32_against_f32"] = agree

    # where a step's device time goes, both precisions
    steps = {}
    for on in (False, True):
        key = "tf32" if on else "f32"
        with tf32(on):
            table, busy = profile_run(lambda: trainers[on].train_step(
                x, y, SEG_LR, gens[on]), out_dir,
                f"profile_seg_train_step_{key}.txt")
        steps[key] = busy
        log(f"  profiled train step, TF32 {'on' if on else 'off'}: device "
            f"busy {busy['device_busy_ms']:.2f} ms of {busy['wall_ms']:.2f}, "
            f"idle share {busy['idle_share']:.3f}, {busy['device_ops']} "
            f"operations")
        log("\n".join(table.splitlines()[:14]))
    res["profiled_train_step"] = steps

    # one trainer's peak: a TF32-off step with only its model resident
    del trainers[True], ev
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainers[False].train_step(x, y, SEG_LR, gens[False])
    torch.cuda.synchronize()
    res["train_step_peak_bytes"] = torch.cuda.max_memory_allocated()

    bounds = {"conv_macs_forward": fwd_macs, "conv_macs_step": step_macs}
    for name, peak in (("f32", F32_OPS_PER_S), ("tf32", TF32_OPS_PER_S)):
        bounds[f"forward_ms_{name}"] = 1e3 * 2 * fwd_macs / peak
        bounds[f"step_ms_{name}"] = 1e3 * 2 * step_macs / peak
    res["bounds"] = bounds
    log(f"  peak memory of a batch-{SEG_BATCH} step: "
        f"{res['train_step_peak_bytes'] / 2**30:.2f} GiB")
    log(f"  convolutions: {fwd_macs / 1e9:.1f} GMAC a forward, "
        f"{step_macs / 1e9:.1f} a step; least ms at the f32 / TF32 dense "
        f"peaks (67 / 495 TFLOP/s): forward {bounds['forward_ms_f32']:.2f} "
        f"/ {bounds['forward_ms_tf32']:.2f} against "
        f"{evals['f32']['ms_median']:.2f} / {evals['tf32']['ms_median']:.2f}"
        f" measured, step {bounds['step_ms_f32']:.2f} / "
        f"{bounds['step_ms_tf32']:.2f} against "
        f"{train['f32']['ms_median']:.2f} / {train['tf32']['ms_median']:.2f}")
    torch.backends.cudnn.benchmark = False
    return res


# ---------------------------------------------------------------- joint step
# cfg/exp/one_step_joint/s00_lr1e-5.yml (its renderer and nerf blocks: 24 +
# 8 proposal-placed samples, occupancy on, 8 × 4 levels; model 40 classes;
# optimizer Adam, lr_seg 1e-5, lr_nerf 1e-2; batch 4)
JOINT_EXP = {"optimizer": {"lr_seg": 1.0e-5, "lr_nerf": 1.0e-2,
                           "name": "Adam"},
             "nerf": {"use_occupancy": True}}
JOINT_NEW = 4  # one_step_joint's batch_new
JOINT_STEPS = 4
# cfg/exp/cl_base.yml (batch 2, ngp_25k_ratio 1): 1 new, 1 old, 2 cl frames
CL_STEPS = 2
PSEUDO_FRAMES = 8
FIT_STEPS = 16  # one epoch: the refresh (every 16 steps) falls inside
PREDICT_FRAMES = 2
# the first joint step's seg loss, kernel path against plain path (set
# before the first run): the seg inputs differ only as the two renders do,
# a label flipped at a near-tie on a share f of the rendered pixels moving
# the mean CE by ~f (PERF.md §2)
JOINT_SEG_LOSS_REL = 5e-3
# the kernels a joint step launches (render and NeRF updates), and those
# the phase's refresh adds
JOINT_KERNELS = RENDER_KERNELS + ("hash_encode_bwd", "composite_bwd",
                                  "mlp_bwd")
REFRESH_KERNELS = ("hash_encode_sampled", "occ_grid_update")


def joint_phase(targets, device, seed, out_dir):
    """Phase 8: JointTrainer at full width (the shipped Semantic-NeRF, fresh;
    DeepLabV3-R101, 40 classes, seeded) on the kernel path and, from the
    same state with the same draws, on the plain path (kernels
    .plain_versions()), each step of one in turn with the other's: 8
    frames' pseudo-labels, one 16-step nerf_fit_epoch, 4 joint_steps of 4
    new frames, 2 of 1 new + 1 old + 2 cl frames, one fused_image_step of
    4 images and 2 predict_frames. The new scene's frames are phase 4's
    test renders (`targets`). TF32 on (PERF.md §6's seg recommendation) on
    both sides; cudnn.benchmark off."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3,
                                                        SemanticNeRF)
    from ucsa_neural_rendering_tpu_torch.train import JointTrainer

    H, W = SEG_HW
    frames = [targets[i % len(targets)] for i in range(PSEUDO_FRAMES)]
    poses = torch.stack([torch.as_tensor(look_at(POSES[i % len(POSES)]),
                                         device=device)
                         for i in range(PSEUDO_FRAMES)])
    scene = {"img": torch.stack([f["nerf_rgb"] for f in frames]),
             "depth": torch.stack([f["nerf_depth"] for f in frames]),
             "pose": poses,
             "intrinsics": torch.tensor(INTRINSICS, device=device).expand(
                 PSEUDO_FRAMES, 4),
             "one_m_to_scene_uom": torch.ones(PSEUDO_FRAMES, device=device)}
    batch = lambda idx: {k: v[idx] for k, v in scene.items()}
    replay_img, replay_lab = seg_batch(seed + 5, 3, device)
    old = {"img": replay_img[:1], "nerf_label": replay_lab[:1]}
    cl = {"replay_img": replay_img[None, 1:], "replay_label":
          replay_lab[None, 1:]}

    def make():
        nerf = SemanticNeRF(**TRAIN_MODEL, device=device,
                            generator=torch.Generator().manual_seed(seed))
        seg = DeepLabV3(num_classes=SEG_CLASSES, device=device,
                        generator=torch.Generator().manual_seed(seed + 1))
        jt = JointTrainer(JOINT_EXP, image_hw=SEG_HW,
                          num_classes=SEG_CLASSES, render_cfg=train_config(),
                          n_rays=N_RAYS, nerf_model=nerf, seg_model=seg,
                          device=device)
        jt.init()
        return {"jt": jt, "grid": jt.init_occupancy(),
                "gen": torch.Generator(device).manual_seed(seed + 2),
                "nerf_losses": [], "ms": {}}

    sides = {"kernel": make(), "plain": make()}
    for side in sides.values():
        # each NeRF step's losses, as the trainer returns them
        step_on_rays = side["jt"].nerf.step_on_rays

        def recorded(*a, side=side, step_on_rays=step_on_rays, **kw):
            parts = step_on_rays(*a, **kw)
            side["nerf_losses"].append(parts)
            return parts
        side["jt"].nerf.step_on_rays = recorded

    def sync():
        """The plain side takes the kernel side's state: both nets, their
        optimizers, the grid and the slab counter."""
        k, p = sides["kernel"], sides["plain"]
        for name in ("nerf", "seg"):
            src, dst = getattr(k["jt"], name), getattr(p["jt"], name)
            dst.model.load_state_dict(src.model.state_dict())
            # a copy: load_state_dict keeps tensors already on the device
            # as they are, and the two optimizers would share moments
            dst.optimizer.load_state_dict(
                copy.deepcopy(src.optimizer.state_dict()))
        p["grid"] = k["grid"].clone()
        p["jt"].nerf._occ_slab = k["jt"].nerf._occ_slab
        p["gen"].set_state(k["gen"].get_state())

    def both(i, name, fn):
        """fn(side) on each side, in turns (kernel first on even i), timed
        (host clock, synchronised); the plain side inside
        plain_versions(), which must launch nothing. Returns the outputs."""
        out = {}
        for which in (("kernel", "plain") if i % 2 == 0 else
                      ("plain", "kernel")):
            side = sides[which]
            before = dict(kernels.LAUNCHES)
            ctx = (kernels.plain_versions() if which == "plain"
                   else contextlib.nullcontext())
            with ctx:
                out[which], ms = timed(lambda: fn(side))
            if which == "plain":
                assert kernels.LAUNCHES == before, name
            side["ms"].setdefault(name, []).append(ms)
        return out

    def check_finite(logs):
        for k, v in logs.items():
            assert math.isfinite(float(v)), (k, logs)

    res = {"exp": JOINT_EXP, "new_batch": JOINT_NEW,
           "seg_loss_rel_limit": JOINT_SEG_LOSS_REL}
    kernels.reset_launches()
    torch.backends.cudnn.benchmark = False
    with tf32(True):
        # phase 1: the pseudo-labels (after an untimed first forward of
        # the fresh nets, which sets up cuDNN), then one epoch over 16
        # frames
        for side in sides.values():
            side["jt"].seg_pseudo_labels(scene["img"])
        pseudo = both(0, "pseudo", lambda s: s["jt"].seg_pseudo_labels(
            scene["img"]))
        # no hand kernel in the seg net: the same cuDNN calls on both sides
        assert (pseudo["kernel"] == pseudo["plain"]).float().mean() >= 0.999
        bufs = {k: torch.cat([v, v]) for k, v in scene.items()}
        bufs["pseudo"] = torch.cat([pseudo["kernel"]] * 2)
        order = torch.randperm(FIT_STEPS, generator=torch.Generator()
                               .manual_seed(seed + 3)).tolist()

        def epoch(s):
            s["grid"], step, parts = s["jt"].nerf_fit_epoch(
                bufs, order, s["gen"], 0, s["grid"])
            assert step == FIT_STEPS and s["jt"].nerf._occ_slab == 1
            return parts
        fit = both(0, "fit_epoch", epoch)
        launches_fit = dict(kernels.LAUNCHES)
        for which, side in sides.items():
            losses = [float(p["loss_nerf_total"])
                      for p in side["nerf_losses"]]
            assert len(losses) == FIT_STEPS and all(map(math.isfinite,
                                                        losses)), losses
            # the NeRF loss falls over the epoch
            assert statistics.mean(losses[-4:]) < statistics.mean(
                losses[:4]), (which, losses)
            side["fit_losses"] = losses
        step1 = loss_err({k: float(v) for k, v in
                          sides["kernel"]["nerf_losses"][0].items()},
                         {k: float(v) for k, v in
                          sides["plain"]["nerf_losses"][0].items()})
        assert step1 <= 2e-3, step1
        res["fit"] = {"step1_loss_rel": step1,
                      "epoch_parts": {k: float(v) for k, v in
                                      fit["kernel"].items()}}

        # phase 2 from one state: the test-config render of the first new
        # batch, then the joint steps
        sync()
        first = list(range(JOINT_NEW))
        rend = both(0, "render_new_batch", lambda s: s["jt"].render_frames(
            scene["pose"][first], INTRINSICS, s["grid"]))
        labels_equal = (rend["kernel"]["nerf_semantics"] ==
                        rend["plain"]["nerf_semantics"]).float().mean().item()
        rgb_mean = (rend["kernel"]["nerf_rgb"] - rend["plain"]["nerf_rgb"]
                    ).abs().mean().item()
        assert labels_equal >= 0.99 and rgb_mean <= 1e-3, (labels_equal,
                                                           rgb_mean)
        joint_logs, step_launches = [], None
        for i in range(JOINT_STEPS):
            idx = [(JOINT_NEW * i + k) % PSEUDO_FRAMES
                   for k in range(JOINT_NEW)]
            before = dict(kernels.LAUNCHES)
            logs = both(i, "joint_step", lambda s: s["jt"].joint_step(
                None, batch(idx), None, s["gen"], s["grid"]))
            if step_launches is None:
                step_launches = {k: kernels.LAUNCHES[k] - before[k]
                                 for k in before}
            for side_logs in logs.values():
                check_finite(side_logs)
            joint_logs.append(logs)
        l1 = {w: {k: float(v) for k, v in joint_logs[0][w].items()}
              for w in sides}
        seg_rel = abs(l1["kernel"]["loss_seg"] / l1["plain"]["loss_seg"] - 1)
        nerf_rel = loss_err({k: v for k, v in l1["kernel"].items()
                             if k != "loss_seg"},
                            {k: v for k, v in l1["plain"].items()
                             if k != "loss_seg"})
        assert nerf_rel <= 2e-3 and seg_rel <= JOINT_SEG_LOSS_REL, \
            (nerf_rel, seg_rel, l1)
        for i in range(CL_STEPS):
            logs = both(i, "cl_step", lambda s: s["jt"].joint_step(
                old, batch([i]), cl, s["gen"], s["grid"]))
            for side_logs in logs.values():
                check_finite(side_logs)

        # the fused image step at 4 images from one state: losses within
        # 2e-3, per-level table-gradient sums within 5e-4 of the mass
        sync()
        fused = both(0, "fused_image_step", lambda s: s["jt"].fused_image_step(
            scene["img"][first], rend["kernel"]["nerf_semantics"],
            scene["depth"][first], scene["pose"][first],
            scene["intrinsics"][first], scene["one_m_to_scene_uom"][first],
            s["gen"], s["grid"]))
        fused_rel = loss_err({k: float(v) for k, v in fused["kernel"].items()},
                             {k: float(v) for k, v in fused["plain"].items()})
        spec = sides["kernel"]["jt"].nerf.model.encoder.spec
        fused_sums = sum_err(*(_level_sums(
            sides[w]["jt"].nerf.model.encoder.table.grad, spec)
            for w in ("kernel", "plain")))
        assert fused_rel <= 2e-3 and fused_sums <= 5e-4, (fused_rel,
                                                          fused_sums)

        # predict from one state: one frame of the given image, one novel
        sync()
        pred_equal = []
        for i in range(PREDICT_FRAMES):
            image = scene["img"][i] if i == 0 else None
            pred = both(i, "predict_frame", lambda s: s["jt"].predict_frame(
                scene["pose"][i], INTRINSICS, image=image,
                occ_grid=s["grid"]))
            pred_equal.append((pred["kernel"]["nerf_semantics"] ==
                               pred["plain"]["nerf_semantics"]).float()
                              .mean().item())
            assert pred["kernel"]["seg_semantics"].shape == (H, W)
        assert min(pred_equal) >= 0.99, pred_equal
        launches = dict(kernels.LAUNCHES)

        missing = [k for k in JOINT_KERNELS + REFRESH_KERNELS
                   if launches[k] <= 0]
        assert not missing, f"kernels not launched on the joint path: " \
            f"{missing}"
        missing = [k for k in JOINT_KERNELS if step_launches[k] <= 0]
        assert not missing, f"kernels not launched by a joint step: {missing}"

        # where a joint step's time goes: one profiled step, the
        # augmentation of its 4 renders alone; a joint step's peak with one
        # trainer resident
        jt, grid, gen = (sides["kernel"][k] for k in ("jt", "grid", "gen"))
        plain = sides.pop("plain")
        p_ms, plain_fit_losses = plain["ms"], plain["fit_losses"]
        del plain
        torch.cuda.empty_cache()
        table, busy = profile_run(lambda: jt.joint_step(
            None, batch(first), None, gen, grid), out_dir,
            "profile_joint_step.txt")
        aug_table, aug = profile_run(lambda: jt._augment_rendered(
            rend["kernel"]["nerf_rgb"], rend["kernel"]["nerf_semantics"],
            gen), out_dir, "profile_joint_augment.txt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        jt.joint_step(None, batch(first), None, gen, grid)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

    k_ms = sides["kernel"]["ms"]
    med = statistics.median
    # the profiler's own host cost stretches the profiled step
    busy["idle_share_unprofiled"] = 1.0 - (busy["device_busy_ms"]
                                           / med(k_ms["joint_step"]))
    res.update(
        ms=k_ms, plain_ms=p_ms,
        joint_step_ms_median=med(k_ms["joint_step"]),
        new_images_per_s=JOINT_NEW / med(k_ms["joint_step"]) * 1e3,
        cl_step_ms_median=med(k_ms["cl_step"]),
        fit_ms_per_image=k_ms["fit_epoch"][0] / FIT_STEPS,
        predict_ms_per_frame=med(k_ms["predict_frame"]),
        pseudo_ms_per_frame=k_ms["pseudo"][0] / PSEUDO_FRAMES,
        fused_step_ms=k_ms["fused_image_step"][0],
        render_labels_equal=labels_equal, render_rgb_mean=rgb_mean,
        step1_nerf_loss_rel=nerf_rel, step1_seg_loss_rel=seg_rel,
        fused_loss_rel=fused_rel, fused_level_sums=fused_sums,
        predict_labels_equal=pred_equal,
        fit_losses=sides["kernel"]["fit_losses"],
        fit_losses_plain=plain_fit_losses,
        joint_logs=[{w: {k: float(v) for k, v in logs[w].items()}
                     for w in logs} for logs in joint_logs],
        launches=launches, launches_fit=launches_fit,
        launches_joint_step=step_launches, peak_bytes=peak,
        profiled_joint_step=busy, augment=aug)
    log(f"  pseudo-labels {res['pseudo_ms_per_frame']:.2f} ms a frame (a "
        f"batch of {PSEUDO_FRAMES}); fit "
        f"{res['fit_ms_per_image']:.2f} ms an image (epoch of {FIT_STEPS}, "
        f"loss {res['fit_losses'][0]:.4f} → {res['fit_losses'][-1]:.4f}, "
        f"step 1 {step1:.2e} of plain)")
    log(f"  joint step ({JOINT_NEW} new): {res['joint_step_ms_median']:.2f} "
        f"ms median of {[round(t, 2) for t in k_ms['joint_step']]} "
        f"({res['new_images_per_s']:.2f} new images/s); plain path "
        f"{[round(t, 2) for t in p_ms['joint_step']]}; cl step (1 new, 1 "
        f"old, 2 cl) "
        f"{res['cl_step_ms_median']:.2f} ms; fused image step "
        f"{res['fused_step_ms']:.2f} ms; predict "
        f"{res['predict_ms_per_frame']:.2f} ms a frame")
    log(f"  agreement with the plain path: rendered labels {labels_equal:.5f}"
        f" (limit 0.99), rgb mean {rgb_mean:.2e}; step 1 NeRF losses "
        f"{nerf_rel:.2e} (limit 2e-3), seg loss {seg_rel:.2e} (limit "
        f"{JOINT_SEG_LOSS_REL}); fused step losses {fused_rel:.2e}, level "
        f"sums {fused_sums:.2e} of the mass (limit 5e-4); predict labels "
        f"{[round(v, 5) for v in pred_equal]}")
    log(f"  a joint step's peak memory {peak / 2**30:.2f} GiB ({peak} bytes)"
        f"; profiled: device busy {busy['device_busy_ms']:.2f} ms of "
        f"{busy['wall_ms']:.2f}, idle share {busy['idle_share']:.3f} "
        f"(against the median unprofiled step "
        f"{busy['idle_share_unprofiled']:.3f}), {busy['device_ops']} "
        f"operations; augmentation alone "
        f"{aug['device_busy_ms']:.3f} ms device in {aug['device_ops']} "
        f"launches ({aug['wall_ms']:.2f} ms wall)")
    log("  kernels' device ms in the profiled joint step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in busy["kernel_ms"].items()))
    log(f"  launches per joint step: "
        f"{ {k: v for k, v in step_launches.items() if v} }")
    log("\n".join(table.splitlines()[:18]))
    return res


# -------------------------------------------------------------------- stage
# the user's unit of work, one adaptation stage through the port's CLI
# (run_scripts/one_step_joint_train.sh: a NeRF fit, joint training, the
# predict dumps, deeplab_ckpt for the next stage), on the synthetic room
STAGE_EXP = os.path.join("cfg", "exp", "one_step_joint", "s00_lr1e-5.yml")
STAGE_SCENE = "scene0000_00"
STAGE_FRAMES = 20  # 16 train + 4 val frames (the 80/20 split), 240×320
STAGE_EPOCHS = (2, 1)  # NeRF fit, joint; the reference runs 10 + 50
STAGE_PHASES = ("nerf_epoch", "test_pre", "val_pre", "joint_epoch",
                "joint_val", "test_final", "predict_final")
# every kernel of the stage's path: the render's, the NeRF step's and the
# refresh's (hash_encode_face_fwd runs only under stochastic_fwd "face")
STAGE_KERNELS = JOINT_KERNELS + REFRESH_KERNELS
# the saved nerf_ckpt re-rendered on the plain path against the predict
# PNGs (set before the first run): the share of equal labels, and of rgb
# within 1 level
STAGE_RERENDER_SHARE = 0.99
IMPORT_PROBE = "\n".join([
    "import importlib",
    "for name in ('cv2', 'PIL', 'imageio', 'yaml', 'pandas', "
    "'torchvision'):",
    "    try:",
    "        importlib.import_module(name)",
    "        print(name, 'yes', end='; ')",
    "    except Exception as e:",
    "        print(name, f'no ({type(e).__name__})', end='; ')",
])


NATIVE_HEADERS = ("jpeglib.h", "png.h", "zlib.h")
NATIVE_LIBS = ("jpeg", "png", "z")
# the runtime libraries the native loader's build links, by the ABI of the
# headers it is built against here (libjpeg 6.2, libpng 1.6, zlib 1)
NATIVE_SONAMES = {"jpeg": "libjpeg.so.62", "png": "libpng16.so.16",
                  "z": "libz.so.1"}


def native_loader_probe():
    """What the machine offers the port's native loader
    (data/native_loader.py: libjpeg, libpng and zlib through ctypes), and
    the route that follows (ROADMAP): (a) the compiler finds jpeglib.h,
    png.h and zlib.h and links -ljpeg -lpng -lz: build as on the CPU
    machine; (b) only the runtime libraries, at the sonames of the ABI the
    headers declare (NATIVE_SONAMES): a build would need the headers
    carried and a link by file name; (c) neither: the loader stays
    unavailable. Looks in `ldconfig -p`, at ctypes.util.find_library and at
    the libraries bundled beside cv2 and PIL in site-packages; reads
    libpng's and zlib's versions from the libraries themselves. A probe,
    no check."""
    import ctypes
    import ctypes.util
    import glob
    import shutil
    import site
    import tempfile
    cxx = shutil.which("g++") or shutil.which("c++")
    out = {"compiler": cxx}

    def run(*argv, source=""):
        return subprocess.run([cxx, *argv], input=source, capture_output=True,
                              text=True, timeout=120)

    if cxx is not None:
        for header in NATIVE_HEADERS:
            out[header] = run("-E", "-x", "c++", "-", "-o", os.devnull,
                              source="#include <cstdio>\n"
                              f"#include <{header}>\n").returncode == 0
        with tempfile.TemporaryDirectory() as tmp:
            for lib in NATIVE_LIBS:
                out[f"-l{lib}"] = run(
                    "-x", "c++", "-", "-o", os.path.join(tmp, "a.out"),
                    f"-l{lib}", source="int main() { return 0; }\n"
                ).returncode == 0
        lines = run("-E", "-x", "c++", "-", "-v", "-o", os.devnull).stderr \
            .splitlines()
        start = "#include <...> search starts here:"
        if start in lines and "End of search list." in lines:
            out["include_paths"] = [x.strip() for x in lines[
                lines.index(start) + 1:lines.index("End of search list.")]]
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        cache = subprocess.run([ldconfig, "-p"], capture_output=True,
                               text=True, timeout=60).stdout
    except OSError as e:
        cache = ""
        out["ldconfig_error"] = str(e)
    out["ldconfig"] = sorted({ln.split(" => ")[-1].strip()
                              for ln in cache.splitlines()
                              if any(f"lib{n}" in ln for n in
                                     ("jpeg", "png", "z.so", "turbojpeg"))})
    out["find_library"] = {n: ctypes.util.find_library(n)
                           for n in ("jpeg", "png16", "png", "z")}
    bundled = []
    for sp in site.getsitepackages():
        for pat in ("opencv_python*.libs", "cv2", "pillow*.libs", "PIL",
                    "Pillow*.libs", "torchvision*", "torchvision.libs"):
            for d in glob.glob(os.path.join(sp, pat)):
                bundled += [f for f in glob.glob(
                    os.path.join(d, "**", "*.so*"), recursive=True)
                            if any(k in os.path.basename(f)
                                   for k in ("jpeg", "png", "libz"))]
    out["bundled"] = sorted(bundled)
    found = {}
    for key, soname in NATIVE_SONAMES.items():
        # a bundled copy carries a hash in its name (libjpeg-<hash>.so.62.x)
        stem, abi = soname.split(".so.")
        hits = [p for p in out["ldconfig"] + out["bundled"]
                if os.path.basename(p) == soname
                or (os.path.basename(p).startswith(stem + "-")
                    and f".so.{abi}" in os.path.basename(p))]
        fl = out["find_library"].get("png16" if key == "png" else key)
        if not hits and fl == soname:
            hits = [soname]
        found[key] = hits[0] if hits else None
    out["sonames"] = found
    versions = {}
    for key, sym in (("png", "png_access_version_number"),
                     ("z", "zlibVersion")):
        if found[key]:
            try:
                fn = getattr(ctypes.CDLL(found[key]), sym)
                if key == "z":
                    fn.restype = ctypes.c_char_p
                    versions[key] = fn().decode()
                else:
                    versions[key] = int(fn())
            except OSError as e:
                versions[key] = f"not loadable: {e}"
    out["versions"] = versions
    if cxx and all(out.get(h) for h in NATIVE_HEADERS) and \
            all(out.get(f"-l{n}") for n in NATIVE_LIBS):
        out["route"] = "a"
    elif all(found.values()):
        out["route"] = "b"
    else:
        out["route"] = "c"
    return out


def _yaml(value, indent=0):
    """Block-YAML lines of a config tree of dicts, lists and scalars that
    the port's reader (and PyYAML) read back as the same tree."""
    pad = " " * indent
    if isinstance(value, dict):
        lines = []
        for k, v in value.items():
            if isinstance(v, (dict, list)):
                lines += [f"{pad}{k}:"] + _yaml(v, indent + 2)
            else:
                lines.append(f"{pad}{k}: {_yaml_scalar(v)}")
        return lines
    return [f"{pad}- {_yaml_scalar(v)}" for v in value]


def _yaml_scalar(v):
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        s = repr(v)  # YAML 1.1 needs a dot in the mantissa
        mant, _, exp = s.partition("e")
        return (mant if "." in mant else mant + ".0") + \
            (f"e{exp}" if exp else "")
    if isinstance(v, int):
        return str(v)
    return json.dumps(v)


def stage_phase(device, seed, out_dir, card):
    """Phase 10: one adaptation stage through the port's CLI
    (scripts/train_joint.main) on the card, at full width, on a synthetic
    room written by the port's writer: STAGE_FRAMES frames of 240×320 with
    PNG colour, a seeded full-width DeepLabV3-R101 saved as the stage's
    checkpoint_load, cfg/exp/one_step_joint/s00_lr1e-5.yml read by the
    port's loader (val_scenes the room, trainer.profiler on), the
    environment in a temporary directory; --nerf_train_epoch 2
    --joint_train_epoch 1. Counts zeroed before, read after: every kernel
    of the path launched. Checks: every logged loss finite and the fit's
    loss falling from epoch 1 to 2; deeplab_ckpt, nerf_ckpt and last_ckpt
    written, last_ckpt bit-equal to the state in memory; one PNG a frame
    in each predict folder, the labels in 1..40; the saved nerf_ckpt,
    loaded into a fresh model, re-renders the predict frames inside
    plain_versions() with the dumped labels on >= STAGE_RERENDER_SHARE of
    the pixels and the rgb within 1 level on as many; a second call with
    trainer.resume_from_checkpoint and --joint_train_epoch 2 resumes at 3
    of 2 + 2 epochs and runs only the last."""
    import gc
    import tempfile

    import numpy as np

    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.config import load_yaml
    from ucsa_neural_rendering_tpu_torch.data import ScanNetNGPJoint
    from ucsa_neural_rendering_tpu_torch.data.image_io import read_png
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_scene_dir
    from ucsa_neural_rendering_tpu_torch.models import DeepLabV3
    from ucsa_neural_rendering_tpu_torch.scripts import train_joint
    from ucsa_neural_rendering_tpu_torch.train import JointTrainer, joint_loop
    from ucsa_neural_rendering_tpu_torch.train.checkpoints import (
        load_tree, save_deeplab)

    H, W = SEG_HW
    res = {"card": card, "frames": STAGE_FRAMES, "epochs": STAGE_EPOCHS,
           "exp": STAGE_EXP}
    saved_env = os.environ.get("ENV_WORKSTATION_NAME")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stage_") as tmp:
        t0 = time.perf_counter()
        env = {"results": os.path.join(tmp, "results"),
               "scannet": os.path.join(tmp, "scans"),
               "scannet_frames_25k": os.path.join(tmp, "frames_25k")}
        write_synthetic_scene_dir(env["scannet"], STAGE_SCENE,
                                  n_frames=STAGE_FRAMES, H=H, W=W,
                                  color_ext=".png")
        ckpt = os.path.join(tmp, "pretrained_deeplab")
        save_deeplab(ckpt, DeepLabV3(
            num_classes=SEG_CLASSES, device="cpu",
            generator=torch.Generator().manual_seed(seed)).state_dict())
        res["setup_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "env.yml"), "w") as f:
            f.write("\n".join(_yaml(env)) + "\n")
        os.environ["ENV_WORKSTATION_NAME"] = os.path.join(tmp, "env")
        exp = load_yaml(os.path.join(REPO, STAGE_EXP))
        exp["general"]["checkpoint_load"] = ckpt
        exp["val_scenes"] = [STAGE_SCENE]
        exp["trainer"]["profiler"] = True
        exp_path = os.path.join(tmp, "stage.yml")
        run = os.path.join(env["results"], exp["general"]["name"])
        steps_path = os.path.join(run, "profile_steps.jsonl")

        def cli(joint_epochs, resume):
            exp["trainer"]["resume_from_checkpoint"] = resume
            with open(exp_path, "w") as f:
                f.write("\n".join(_yaml(exp)) + "\n")
            assert load_yaml(exp_path) == exp
            done = (sum(1 for _ in open(steps_path))
                    if os.path.exists(steps_path) else 0)
            argv = ["--exp", exp_path, "--exp_name", "stage",
                    "--nerf_train_epoch", str(STAGE_EPOCHS[0]),
                    "--joint_train_epoch", str(joint_epochs),
                    "--seed", str(seed)]
            kernels.reset_launches()
            # the earlier phases' garbage out, so that the peak is the
            # stage's own (above what stays allocated at its start)
            gc.collect()
            torch.cuda.empty_cache()
            res.setdefault("start_bytes", []).append(
                torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            (trainer, grid), ms = timed(lambda: train_joint.main(argv))
            lines = [json.loads(x) for x in open(steps_path)][done:]
            return trainer, grid, ms, dict(kernels.LAUNCHES), lines

        try:
            # the stage, as a user runs it
            trainer, grid, ms, launches, steps = cli(STAGE_EPOCHS[1], False)
            res["wall_s"] = ms / 1e3
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
            res["launches"] = launches
            missing = [k for k in STAGE_KERNELS if launches[k] <= 0]
            assert not missing, f"not launched in the stage: {missing}"
            tags = [x["tag"] for x in steps]
            assert tags == ["nerf_epoch"] * STAGE_EPOCHS[0] + \
                list(STAGE_PHASES[1:]), tags
            res["steps"] = steps
            res["phase_s"] = {}
            for x in steps:
                res["phase_s"][x["tag"]] = res["phase_s"].get(x["tag"], 0) \
                    + x["seconds"]
            predict = ScanNetNGPJoint(env["scannet"], [STAGE_SCENE],
                                      mode="predict", exp_name="stage",
                                      output_size=SEG_HW)
            res["predict_ms_per_frame"] = \
                1e3 * res["phase_s"]["predict_final"] / len(predict)

            # logged losses finite; the fit's loss falls
            records = [json.loads(x) for x in open(os.path.join(
                run, "metrics.jsonl"))]
            losses = [(r["step"], k, v) for r in records for k, v in r.items()
                      if "loss" in k]
            assert losses and all(math.isfinite(v) for _, _, v in losses)
            fit = [v for step, k, v in losses
                   if k == "train/loss_nerf_total" and step < STAGE_EPOCHS[0]]
            res["fit_loss"] = fit
            assert len(fit) == 2 and fit[1] < fit[0], fit

            # the checkpoints; last_ckpt holds the state in memory
            for name in ("deeplab_ckpt", "nerf_ckpt", "last_ckpt"):
                assert os.path.isdir(os.path.join(run, name)), name
            last = load_tree(os.path.join(run, "last_ckpt"),
                             map_location=device)
            assert last["done"] == sum(STAGE_EPOCHS)
            _assert_same_bits(
                {k: last[k] for k in ("nerf", "nerf_opt", "seg", "seg_opt",
                                      "occ_slab", "occ_grid")},
                {**trainer.state_dict(), "occ_grid": grid})

            # the predict dumps: one PNG a frame, labels in 1..40
            scene_exp = os.path.join(env["scannet"], STAGE_SCENE, "stage")
            for name in joint_loop.PREDICT_SUBFOLDERS:
                files = sorted(os.listdir(os.path.join(scene_exp, name)))
                assert len(files) == len(predict) == STAGE_FRAMES, name
            items = [predict[i] for i in range(len(predict))]
            dumped = {k: np.stack([read_png(os.path.join(
                scene_exp, k, it["current_index"] + ".png")) for it in items])
                for k in ("nerf_label", "nerf_image")}
            assert dumped["nerf_label"].min() >= 1 and \
                dumped["nerf_label"].max() <= SEG_CLASSES

            # the saved nerf_ckpt, in a fresh model, re-rendered on the plain
            # path at the predict budget
            nerf_ckpt = load_tree(os.path.join(run, "nerf_ckpt"),
                                  map_location=device)
            fresh = joint_loop.nerf_model_from_exp(
                exp, SEG_CLASSES, device,
                torch.Generator().manual_seed(seed + 1))
            fresh.load_state_dict(nerf_ckpt["params"])
            render_cfg, _, _ = joint_loop.render_cfgs_from_exp(exp)
            again = JointTrainer(exp, image_hw=SEG_HW,
                                 num_classes=SEG_CLASSES,
                                 render_cfg=render_cfg, nerf_model=fresh,
                                 seg_model=trainer.seg.model, device=device)
            before = dict(kernels.LAUNCHES)
            with kernels.plain_versions():
                out = again.render_frames(
                    np.stack([it["pose"] for it in items]),
                    items[0]["intrinsics"], nerf_ckpt["occ_grid"],
                    which="predict")
            assert kernels.LAUNCHES == before
            labels = out["nerf_semantics"].cpu().numpy() + 1
            rgb = (out["nerf_rgb"].clamp(0, 1) * 255).to(
                torch.uint8).cpu().numpy().astype(np.int64)
            res["rerender_labels_equal"] = float(
                (labels == dumped["nerf_label"]).mean())
            res["rerender_rgb_within_1"] = float(
                (np.abs(rgb - dumped["nerf_image"]) <= 1).mean())
            assert res["rerender_labels_equal"] >= STAGE_RERENDER_SHARE
            assert res["rerender_rgb_within_1"] >= STAGE_RERENDER_SHARE
            del trainer, again, fresh, last, nerf_ckpt

            # a resumed call: 3 of 2 + 2 epochs done, only the last runs
            trainer, grid, ms2, launches2, steps2 = cli(2, True)
            res["resume_wall_s"] = ms2 / 1e3
            res["resume_launches"] = launches2
            tags2 = [(x["tag"], x.get("epoch")) for x in steps2]
            assert tags2 == [("joint_epoch", 1), ("joint_val", 1),
                             ("test_final", None), ("predict_final", None)], \
                tags2
            last = load_tree(os.path.join(run, "last_ckpt"))
            assert last["done"] == STAGE_EPOCHS[0] + 2
            res["resume_steps"] = steps2
            res["resume_phase_s"] = {x["tag"]: x["seconds"] for x in steps2}
            del trainer, last
        finally:
            if saved_env is None:
                os.environ.pop("ENV_WORKSTATION_NAME", None)
            else:
                os.environ["ENV_WORKSTATION_NAME"] = saved_env
    log(f"  {card}: stage of {STAGE_EPOCHS[0]} + {STAGE_EPOCHS[1]} epochs "
        f"over {STAGE_FRAMES} frames: {res['wall_s']:.2f} s wall "
        f"(setup {res['setup_s']:.2f} s before it), peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB ({res['peak_bytes']} bytes; "
        f"{res['start_bytes'][0]} allocated at its start)")
    log("  phase seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["phase_s"].items()))
    log(f"  predict {res['predict_ms_per_frame']:.2f} ms a frame (the PNG "
        f"dumps included); fit loss {res['fit_loss']}; nerf_ckpt re-rendered "
        f"on the plain path: labels {res['rerender_labels_equal']:.5f}, rgb "
        f"within 1 {res['rerender_rgb_within_1']:.5f} (limit "
        f"{STAGE_RERENDER_SHARE})")
    log(f"  launches: { {k: v for k, v in res['launches'].items() if v} }")
    log(f"  resumed call: {res['resume_wall_s']:.2f} s wall, phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["resume_phase_s"].items()))
    return res


# ---------------------------------------------------------------- protocol
# the multi-step continual-learning protocol as run_scripts/multi_step.sh
# runs it (scripts/cl_deeplab.py over cl_base.yml, cl.active: true), cut to
# two stages on two synthetic rooms
CL_EXP = os.path.join("cfg", "exp", "multi_step", "cl_base.yml")
CL_ROOMS = ("scene0000_00", "scene0001_00")
# a room's frames, 240×320: 12 train + 2 val (the 80/20 split), so that a
# stage's 12 fit + 6 joint steps pass the refresh's 16 and every kernel of
# the stage path launches in each stage (12 frames give 10 + 5 steps: no
# refresh in stage 0)
CL_FRAMES = 14
CL_EPOCHS = (1, 1)  # NeRF fit, joint, a stage; the reference runs 10 + 10
CL_25K_SCENES, CL_25K_FRAMES = 2, 8
CL_25K_HW = (968, 1296)  # ScanNet-25k's frames: every replay item shrinks
CL_PHASES = ("nerf_epoch", "test_pre", "val_pre", "joint_epoch",
             "joint_val", "test_final", "test_25k", "predict_final")
CL_RESUMED_PHASES = ("test_final", "test_25k", "predict_final")
# the card's allocated memory at stage 1's start against stage 0's
CL_MEMORY_SLACK = 0.25 * 2**30
CL_ITEM_TIMINGS = 6  # 25k replay items timed on the host, a label format
STEPS_FILE = "profile_steps.jsonl"  # a run's per-phase seconds


def _raw_id(c):
    """A raw ScanNet id for class c (0 stays unlabelled): ids with gaps,
    so that the MAPPED decode's lookup is not the identity."""
    return 0 if c == 0 else 7 * c + 3


def write_cl_data(env, hw, hw_25k, seed):
    """The protocol's data: the two rooms (CL_FRAMES frames at hw, PNG
    colour, palettes 0 and 1), the 25k tree (CL_25K_SCENES ×
    CL_25K_FRAMES frames at hw_25k, JPEG colour) with scene 1's labels
    rewritten as uint16 raw ids behind a tsv with gaps, and its split
    files from the port's create_split script. Returns the split path."""
    import csv

    import numpy as np

    from ucsa_neural_rendering_tpu_torch.data.image_io import (read_png,
                                                                write_png)
    from ucsa_neural_rendering_tpu_torch.data.synthetic import (
        write_synthetic_25k_dir, write_synthetic_scene_dir)
    from ucsa_neural_rendering_tpu_torch.scripts import create_split

    for variant, room in enumerate(CL_ROOMS):
        write_synthetic_scene_dir(env["scannet"], room, n_frames=CL_FRAMES,
                                  H=hw[0], W=hw[1], variant=variant,
                                  color_ext=".png")
    f25k = env["scannet_frames_25k"]
    write_synthetic_25k_dir(f25k, n_scenes=CL_25K_SCENES,
                            n_frames_per_scene=CL_25K_FRAMES, H=hw_25k[0],
                            W=hw_25k[1], frame_gain=0.1, pixel_noise=0.02)
    with open(os.path.join(f25k, "scannetv2-labels.combined.tsv"), "w",
              newline="") as f:
        out = csv.writer(f, delimiter="\t", lineterminator="\n")
        out.writerow(["id", "nyu40id", "raw_category"])
        out.writerows([_raw_id(c), c, f"c{c}"] for c in range(1, 41))
    lut = np.array([_raw_id(c) for c in range(41)], np.uint16)
    label_dir = os.path.join(f25k, "scene0001_00", "label")
    for name in os.listdir(label_dir):
        path = os.path.join(label_dir, name)
        write_png(path, lut[read_png(path)])
    cfg = os.path.join(os.path.dirname(f25k), "split_config.yml")
    with open(cfg, "w") as f:
        f.write("\n".join(_yaml({"data_module": {
            "root": f25k, "data_preprocessing": {
                "val_ratio": 0.2, "image_regex": "/*/color/*.jpg",
                "split_file": "split.npz",
                "split_file_cl": "split_cl.npz"}}})) + "\n")
    return create_split.main(["--config", cfg, "--seed", str(seed)])


def replay_item_ms(f25k, split_cl, hw, seed):
    """Host ms of ScanNet-25k replay items as the joint loader's thread
    makes them (JPEG decode, label PNG decode, rescale, host augment), for
    each label format (scene 0 FAST, scene 1 MAPPED): whole items and one
    item's parts."""
    import numpy as np

    from ucsa_neural_rendering_tpu_torch.data import (ScanNet, host_augment,
                                                      load_split,
                                                      rescale_to_canonical)
    from ucsa_neural_rendering_tpu_torch.data.image_io import read_rgb
    paths = load_split(split_cl)["train_cl"]
    out = {}
    for fmt, scene in (("FAST", "scene0000_00"), ("MAPPED", "scene0001_00")):
        mine = [p for p in paths if scene in p][:CL_ITEM_TIMINGS]
        ds = ScanNet(f25k, mine, mode="train", output_size=hw, seed=seed)
        items = []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            ds[i]
            items.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        img = read_rgb(mine[0]).astype(np.float32) / 255.0
        t1 = time.perf_counter()
        label, how = ds._label_loader.get(ds.label_pths[0])
        t2 = time.perf_counter()
        img, labels = rescale_to_canonical(img, [label.astype(np.float32)],
                                           hw)
        t3 = time.perf_counter()
        host_augment(seed, img, labels, hw, only_crop=False)
        t4 = time.perf_counter()
        assert how == fmt, (how, fmt)
        parts = {"jpeg_decode": t1 - t0, "label_decode": t2 - t1,
                 "rescale": t3 - t2, "augment": t4 - t3}
        out[fmt] = {"item_ms": items,
                    "item_ms_median": statistics.median(items),
                    "parts_ms": {k: 1e3 * v for k, v in parts.items()},
                    "rescaled_hw": list(img.shape[:2])}
    return out


def protocol_phase(device, seed, out_dir, card, hw=SEG_HW,
                   hw_25k=CL_25K_HW):
    """Phase 11: the multi-step continual-learning protocol as a user runs
    it, in this process on the card: the port's scripts/cl_deeplab
    (parse_args, load_exp_and_env, then cl_driver.main with scene_order
    the two rooms; TF32 on, as the CLI sets it) over
    cfg/exp/multi_step/cl_base.yml read by the port's YAML reader
    (cl.active: true, ngp_25k_ratio 1, replay_buffer_size 100), with a
    seeded full-width DeepLabV3-R101 as stage 0's checkpoint_load,
    trainer.profiler on, and write_cl_data's rooms and 25k tree. Cuts:
    25k_fraction 1.0 in place of 0.1 (0.1 of the 13 train_cl frames would
    leave 1), val_scenes the two rooms, CL_EPOCHS (1 fit + 1 joint epoch a
    stage; the reference runs 10 + 10), 2 stages in place of 10. Counts
    zeroed before, read at each stage's start and end. Checks: every
    kernel of the stage path launched in each stage; every logged loss
    finite; each stage's deeplab_ckpt and nerf_ckpt written; stage 1's seg
    weights at its start bit-equal to stage 0's deeplab_ckpt; stage 1's
    joint steps took old-scene frames, every joint step a cl batch of
    [2, 1, H, W, 3]; test/25k_* logged in both stages, finite; the card's
    allocated memory at stage 1's start within CL_MEMORY_SLACK of stage
    0's. Then a protocol resume: stage 1's deeplab_ckpt and nerf_ckpt
    deleted, its last_ckpt kept, the CLI called again with
    trainer.resume_from_checkpoint: stage 0 skipped (its files keep their
    mtimes), stage 1 resumed at 2 of 2 epochs, running only its final
    test, 25k test, predict and save. Recorded: each stage's wall time,
    per-phase seconds and peak memory, the host ms of a 25k replay item
    and its parts, eval_25k's ms a batch, the launches."""
    import gc
    import shutil
    import tempfile

    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.config import (load_exp_and_env,
                                                        load_yaml)
    from ucsa_neural_rendering_tpu_torch.data import load_split
    from ucsa_neural_rendering_tpu_torch.models import DeepLabV3
    from ucsa_neural_rendering_tpu_torch.scripts import cl_deeplab
    from ucsa_neural_rendering_tpu_torch.train import (JointTrainer,
                                                       cl_driver, joint_loop)
    from ucsa_neural_rendering_tpu_torch.train.checkpoints import (
        load_deeplab, save_deeplab)
    from ucsa_neural_rendering_tpu_torch.train.seg_eval import EVAL_BATCH

    res = {"card": card, "frames": CL_FRAMES, "rooms": list(CL_ROOMS),
           "epochs": CL_EPOCHS, "exp": CL_EXP, "hw": list(hw),
           "frames_25k": [CL_25K_SCENES, CL_25K_FRAMES, *hw_25k]}
    saved_env = os.environ.get("ENV_WORKSTATION_NAME")
    stages = []  # one record a stage: filled by the instrumentation
    real_train = joint_loop.train
    real_init, real_step = JointTrainer.init, JointTrainer.joint_step

    def train(*a, **kw):
        before = dict(kernels.LAUNCHES)
        rec = {"start_bytes": torch.cuda.memory_allocated(), "steps": []}
        stages.append(rec)
        torch.cuda.reset_peak_memory_stats()
        out, rec["wall_ms"] = timed(lambda: real_train(*a, **kw))
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["launches"] = {k: v - before[k]
                           for k, v in kernels.LAUNCHES.items()}
        return out

    def init(trainer, *a, **kw):
        real_init(trainer, *a, **kw)
        stages[-1]["seg_at_start"] = {
            k: v.detach().cpu().clone()
            for k, v in trainer.seg.model.state_dict().items()}

    def joint_step(trainer, old, new, cl, *a, **kw):
        stages[-1]["steps"].append({
            "old": 0 if old is None else len(old["img"]),
            "new": 0 if new is None else len(new["img"]),
            "cl": None if cl is None else {
                k: list(v.shape) for k, v in cl.items()}})
        return real_step(trainer, old, new, cl, *a, **kw)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cl_") as tmp:
        t0 = time.perf_counter()
        env = {"results": os.path.join(tmp, "results"),
               "scannet": os.path.join(tmp, "scans"),
               "scannet_frames_25k": os.path.join(tmp, "frames_25k")}
        with open(os.path.join(tmp, "env.yml"), "w") as f:
            f.write("\n".join(_yaml(env)) + "\n")
        os.environ["ENV_WORKSTATION_NAME"] = os.path.join(tmp, "env")
        try:
            split, split_cl = write_cl_data(env, hw, hw_25k, seed)
            ckpt = os.path.join(tmp, "pretrained_deeplab")
            save_deeplab(ckpt, DeepLabV3(
                num_classes=SEG_CLASSES, device="cpu",
                generator=torch.Generator().manual_seed(seed)).state_dict())
            res["setup_s"] = time.perf_counter() - t0
            res["split"] = {k: len(v) for k, v in load_split(split).items()}
            exp = load_yaml(os.path.join(REPO, CL_EXP))
            exp["general"]["checkpoint_load"] = ckpt
            exp["val_scenes"] = list(CL_ROOMS)
            exp["trainer"]["profiler"] = True
            exp["cl"]["25k_fraction"] = 1.0
            if tuple(hw) != SEG_HW:
                exp["output_size"] = list(hw)
            exp_path = os.path.join(tmp, "cl.yml")
            runs = [os.path.join(env["results"], "protocol", f"stage_{i}")
                    for i in range(len(CL_ROOMS))]

            def cli(resume):
                """The CLI's steps (scripts/cl_deeplab.main) with the
                rooms as the scene order."""
                exp["trainer"]["resume_from_checkpoint"] = resume
                with open(exp_path, "w") as f:
                    f.write("\n".join(_yaml(exp)) + "\n")
                assert load_yaml(exp_path) == exp
                args = cl_deeplab.parse_args([
                    "--exp", exp_path, "--exp_name", "protocol",
                    "--nerf_train_epoch", str(CL_EPOCHS[0]),
                    "--joint_train_epoch", str(CL_EPOCHS[1]),
                    "--seed", str(seed), "--device", device.type])
                torch.backends.cudnn.allow_tf32 = True
                cfg, env_, exp_p, env_p = load_exp_and_env(
                    cl_deeplab.ROOT_DIR, args.exp)
                assert env_ == env
                done = [sum(1 for _ in open(os.path.join(r, STEPS_FILE)))
                        if os.path.exists(os.path.join(r, STEPS_FILE))
                        else 0 for r in runs]
                del stages[:]
                kernels.reset_launches()
                # the earlier phases' garbage out, so that stage 0's start
                # and peak are the protocol's own
                gc.collect()
                torch.cuda.empty_cache()
                joint_loop.train = train
                JointTrainer.init, JointTrainer.joint_step = init, joint_step
                try:
                    results, ms = timed(lambda: cl_driver.main(
                        cfg, env_, args, exp_p, env_p,
                        scene_order=list(CL_ROOMS)))
                finally:
                    joint_loop.train = real_train
                    JointTrainer.init = real_init
                    JointTrainer.joint_step = real_step
                steps = [[json.loads(x) for x in open(os.path.join(
                    r, STEPS_FILE))][n:] for r, n in zip(runs, done)]
                return results, ms, dict(kernels.LAUNCHES), steps

            # the protocol, as a user runs it
            results, ms, launches, steps = cli(False)
            assert results == runs, results
            res["wall_s"] = ms / 1e3
            res["launches"] = launches
            res["stages"] = []
            for i, (rec, lines) in enumerate(zip(stages, steps)):
                missing = [k for k in STAGE_KERNELS if rec["launches"][k] <= 0]
                assert not missing, f"stage {i}: not launched: {missing}"
                tags = [x["tag"] for x in lines]
                assert tags == list(CL_PHASES), (i, tags)
                for name in ("deeplab_ckpt", "nerf_ckpt", "last_ckpt"):
                    assert os.path.isdir(os.path.join(runs[i], name)), name
                records = [json.loads(x) for x in open(os.path.join(
                    runs[i], "metrics.jsonl"))]
                losses = [v for r in records for k, v in r.items()
                          if "loss" in k]
                assert losses and all(math.isfinite(v) for v in losses)
                test_25k = {k: v for r in records for k, v in r.items()
                            if k.startswith("test/25k_")}
                assert sorted(test_25k) == sorted(
                    f"test/25k_{m}" for m in ("mean_IoU", "total_accuracy",
                                              "mean_accuracy")), test_25k
                assert all(math.isfinite(v) for v in test_25k.values())
                assert rec["steps"] and all(
                    st["cl"] == {"replay_img": [2, 1, *hw, 3],
                                 "replay_label": [2, 1, *hw]}
                    for st in rec["steps"]), rec["steps"]
                phase_s = {x["tag"]: x["seconds"] for x in lines}
                n_test = res["split"]["test"]
                res["stages"].append({
                    "scene": CL_ROOMS[i], "wall_s": rec["wall_ms"] / 1e3,
                    "start_bytes": rec["start_bytes"],
                    "peak_bytes": rec["peak_bytes"],
                    "launches": rec["launches"], "phase_s": phase_s,
                    "joint_steps": len(rec["steps"]),
                    "old_frames": sum(st["old"] for st in rec["steps"]),
                    "new_frames": sum(st["new"] for st in rec["steps"]),
                    "joint_step_s": phase_s["joint_epoch"]
                    / len(rec["steps"]),
                    "eval_25k_batches": -(-n_test // EVAL_BATCH),
                    "eval_25k_ms_a_batch": 1e3 * phase_s["test_25k"]
                    / -(-n_test // EVAL_BATCH),
                    "test_25k": test_25k})
            one = res["stages"][1]
            assert one["old_frames"] > 0, "stage 1 took no old-scene frame"
            assert res["stages"][0]["old_frames"] == 0
            _assert_same_bits(stages[1]["seg_at_start"], load_deeplab(
                os.path.join(runs[0], "deeplab_ckpt")), "stage 1 start")
            res["memory_growth_bytes"] = \
                one["start_bytes"] - res["stages"][0]["start_bytes"]
            assert abs(res["memory_growth_bytes"]) <= CL_MEMORY_SLACK, \
                res["memory_growth_bytes"]
            del stages[:]

            # a protocol resume: stage 1's final checkpoints gone, its
            # last_ckpt kept
            for name in ("deeplab_ckpt", "nerf_ckpt"):
                shutil.rmtree(os.path.join(runs[1], name))
            mtimes = {os.path.join(d, f): os.path.getmtime(os.path.join(
                d, f)) for d, _, fs in os.walk(runs[0]) for f in fs}
            results2, ms2, launches2, steps2 = cli(True)
            assert results2 == [None, runs[1]], results2
            assert {p: os.path.getmtime(p) for p in mtimes} == mtimes
            assert steps2[0] == [], steps2[0]
            tags2 = [x["tag"] for x in steps2[1]]
            assert tags2 == list(CL_RESUMED_PHASES), tags2
            for name in ("deeplab_ckpt", "nerf_ckpt"):
                assert os.path.isdir(os.path.join(runs[1], name)), name
            missing = [k for k in RENDER_KERNELS if launches2[k] <= 0]
            assert not missing, f"not launched in the resumed call: {missing}"
            res["resume_wall_s"] = ms2 / 1e3
            res["resume_launches"] = launches2
            res["resume_phase_s"] = {x["tag"]: x["seconds"]
                                     for x in steps2[1]}
            res["replay_item"] = replay_item_ms(
                env["scannet_frames_25k"], split_cl, hw, seed)
        finally:
            if saved_env is None:
                os.environ.pop("ENV_WORKSTATION_NAME", None)
            else:
                os.environ["ENV_WORKSTATION_NAME"] = saved_env
    log(f"  {card}: {len(CL_ROOMS)} stages of {CL_EPOCHS[0]} + "
        f"{CL_EPOCHS[1]} epochs over {CL_FRAMES} frames a room, 25k split "
        f"{res['split']}: {res['wall_s']:.2f} s wall (setup "
        f"{res['setup_s']:.2f} s before it)")
    for i, st in enumerate(res["stages"]):
        log(f"  stage {i}: {st['wall_s']:.2f} s, peak "
            f"{st['peak_bytes'] / 2**30:.2f} GiB ({st['start_bytes']} bytes "
            f"at its start), {st['joint_steps']} joint steps "
            f"({st['joint_step_s'] * 1e3:.1f} ms each, {st['old_frames']} "
            f"old + {st['new_frames']} new frames), eval_25k "
            f"{st['eval_25k_ms_a_batch']:.1f} ms a batch; phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in st["phase_s"].items()))
        log(f"    25k test: {st['test_25k']}")
    log(f"  memory at stage 1's start minus stage 0's: "
        f"{res['memory_growth_bytes']} bytes (limit {CL_MEMORY_SLACK:.0f})")
    for fmt, r in res["replay_item"].items():
        log(f"  25k replay item ({fmt}, {hw_25k[0]}x{hw_25k[1]} -> "
            f"{r['rescaled_hw']} -> {hw}): {r['item_ms_median']:.1f} ms "
            f"median of {len(r['item_ms'])}; one item's parts "
            + ", ".join(f"{k} {v:.1f}" for k, v in r["parts_ms"].items()))
    log(f"  launches: { {k: v for k, v in res['launches'].items() if v} }")
    log(f"  resumed call: {res['resume_wall_s']:.2f} s wall, stage 0 "
        f"skipped, phases " + ", ".join(
            f"{k} {v:.3f}" for k, v in res["resume_phase_s"].items()))
    return res


# ------------------------------------------------------------------- loops
# the reference's other run scripts, each through the port's CLI:
# run_scripts/pretrain.sh (scripts/pretrain over
# cfg/exp/pretrain_scannet_25k_deeplabv3.yml), one_step_nerf_only_train.sh
# (scripts/train_joint --exp_name one_step_nerf_only --joint_train_epoch 0)
# and one_step_finetune_train.sh (scripts/train_finetune over
# cfg/exp/one_step_finetune_nerf/s00_lr1e-5.yml), chained through the
# pretrain's best_ckpt and the NeRF-only stage's dumps
PRETRAIN_EXP = os.path.join("cfg", "exp", "pretrain_scannet_25k_deeplabv3.yml")
FINETUNE_EXP = os.path.join("cfg", "exp", "one_step_finetune_nerf",
                            "s00_lr1e-5.yml")
NERF_ONLY = "one_step_nerf_only"
# the 25k tree: 2 scenes × 9 frames of 968×1296, so that create_split's
# 0.2 leaves 15 train frames, whose last batch of 3 is padded to 4
LOOP_25K_SCENES, LOOP_25K_FRAMES = 2, 9
PRETRAIN_EPOCHS = (2, 3)  # the first call, then the resumed call's total
FINETUNE_EPOCHS = (2, 1)  # without replay, then with (cl.active)
# the room: 16 train + 4 val frames of 240×320 (JPEG colour, as ScanNetNGP
# globs), so that the NeRF-only stage's 16 fit steps reach the refresh
LOOP_FRAMES = 20
NERF_ONLY_EPOCHS = 1  # the reference runs 60
PRETRAIN_PHASES = ("train_epoch", "val_epoch", "last_ckpt")
NERF_ONLY_PHASES = ("nerf_epoch", "test_pre", "val_pre", "test_final",
                    "test_25k", "predict_final")


def _trace_device_ms(path):
    """The summed duration of the device's kernels, copies and fills in a
    torch.profiler Chrome trace (one stream: they do not overlap)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return 1e-3 * sum(e.get("dur", 0) for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy",
                                          "gpu_memset"))


def loops_phase(device, seed, out_dir, card, hw=SEG_HW, hw_25k=CL_25K_HW):
    """Phase 12: the pretrain → NeRF-only stage → finetune chain as a user
    runs it, through the port's three CLIs' main(argv) in this process on
    the card (TF32 on, as each sets it), at full width (DeepLabV3-R101, 40
    classes, batch 4, 240×320; the shipped Semantic-NeRF), the environment
    in a temporary directory:
      (a) scripts/pretrain over cfg/exp/pretrain_scannet_25k_deeplabv3.yml
          on a 25k tree of LOOP_25K_SCENES × LOOP_25K_FRAMES frames at
          ScanNet-25k's 968×1296, split by the port's create_split script;
          cut to 2 epochs (POLY's max_epochs kept at 150), profiler on;
          then a resumed call to 3 epochs, which runs only epoch 3,
          restores best_miou from last_ckpt and leaves last_ckpt equal to
          the state in memory (model and optimizer);
      (b) scripts/train_joint --exp_name one_step_nerf_only
          --nerf_train_epoch 1 --joint_train_epoch 0 over
          cfg/exp/one_step_joint/s00_lr1e-5.yml on a room of LOOP_FRAMES
          frames of 240×320 (JPEG colour), the seg net loaded from (a)'s
          best_ckpt (bit-equal at the stage's start): every kernel of
          STAGE_KERNELS launched, and every train frame has its render and
          label dump;
      (c) scripts/train_finetune over
          cfg/exp/one_step_finetune_nerf/s00_lr1e-5.yml,
          --prev_exp_name one_step_nerf_only, checkpoint_load (a)'s
          best_ckpt, cut to 2 epochs, then 1 epoch with cl.active (25k
          replay from (a)'s tree, ngp_25k_ratio 1, 25k_fraction 1.0): the
          seg weights at the start bit-equal to best_ckpt, the training
          images exactly (b)'s nerf_image PNGs of the train frames, a
          batch of 4 (8 with replay), val* and test/25k_* finite,
          deeplab_ckpt written.
    Every logged loss finite. Recorded: each call's wall time, per-phase
    seconds and peak memory; the pretrain's s an epoch, step ms (the card
    synchronised around each step), the wait for the loader between
    steps, host ms of a 25k item on the loader's thread, device busy in
    its traced first epoch, the epochs that wrote best_ckpt; the NeRF-only
    stage's launches; the finetune's step ms with and without replay and
    ms a batch-1 val frame."""
    import gc
    import tempfile
    import threading

    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.config import load_yaml
    from ucsa_neural_rendering_tpu_torch.data import (ScanNet, ScanNetNGP,
                                                      load_split)
    from ucsa_neural_rendering_tpu_torch.data.synthetic import (
        write_synthetic_25k_dir, write_synthetic_scene_dir)
    from ucsa_neural_rendering_tpu_torch.scripts import (create_split,
                                                         pretrain,
                                                         train_finetune,
                                                         train_joint)
    from ucsa_neural_rendering_tpu_torch.train import (JointTrainer,
                                                       SegTrainer,
                                                       poly_lr_factor,
                                                       pretrain_loop)
    from ucsa_neural_rendering_tpu_torch.train.checkpoints import (
        load_deeplab, load_tree)

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    res = {"card": card, "hw": list(hw),
           "frames_25k": [LOOP_25K_SCENES, LOOP_25K_FRAMES, *hw_25k],
           "room_frames": LOOP_FRAMES}
    # instrumentation: each wrapper records into `rec`, and every one is
    # restored in the finally below
    rec = {}
    lock = threading.Lock()
    real = {"train_step": SegTrainer.train_step, "init": SegTrainer.init,
            "joint_init": JointTrainer.init, "item": ScanNet.__getitem__,
            "ngp_item": ScanNetNGP.__getitem__,
            "ngp_rgb": ScanNetNGP._read_rgb,
            "run_epoch": pretrain_loop.run_epoch,
            "save_deeplab": pretrain_loop.save_deeplab}

    def train_step(trainer, images, *a, **kw):
        sync()
        t0 = time.perf_counter()
        if "last_end" in rec:
            rec["gap_ms"].append(1e3 * (t0 - rec["last_end"]))
        out = real["train_step"](trainer, images, *a, **kw)
        sync()
        rec["last_end"] = time.perf_counter()
        rec["step_ms"].append(1e3 * (rec["last_end"] - t0))
        rec["batch"].append(int(images.shape[0]))
        return out

    def run_epoch(trainer, loader, *a, train=True, epoch=0, **kw):
        rec.pop("last_end", None)  # a gap is between two steps of an epoch
        if train:
            rec["epoch"] = epoch
        return real["run_epoch"](trainer, loader, *a, train=train,
                                 epoch=epoch, **kw)

    def save_deeplab(path, state):
        if os.path.basename(path) == "best_ckpt":
            rec["best_epochs"].append(rec["epoch"])
        return real["save_deeplab"](path, state)

    def timed_item(key):
        """A dataset's __getitem__ timed on the thread that calls it, its
        times kept by dataset and mode."""
        def get(ds, index):
            t0 = time.perf_counter()
            out = real[key](ds, index)
            with lock:
                rec["item_ms"].setdefault(
                    f"{type(ds).__name__} {ds._mode}", []).append(
                    1e3 * (time.perf_counter() - t0))
            return out
        return get

    def init(trainer, state=None):
        out = real["init"](trainer, state)
        if state is not None:
            rec["seg_at_start"] = {k: v.detach().cpu().clone() for k, v in
                                   trainer.model.state_dict().items()}
        return out

    def joint_init(trainer, nerf_params=None, seg_state=None):
        out = real["joint_init"](trainer, nerf_params, seg_state)
        rec["seg_at_start"] = {k: v.detach().cpu().clone() for k, v in
                               trainer.seg.model.state_dict().items()}
        return out

    def ngp_rgb(ds, path):
        if ds._mode == "train":
            with lock:
                rec["ngp_train_reads"].append(path)
        return real["ngp_rgb"](ds, path)

    def cli(main, argv, run):
        """main(argv) with fresh records, the earlier phases' garbage out
        first; returns (its result, its records, its profile_steps
        lines)."""
        steps_path = os.path.join(run, STEPS_FILE)
        done = (sum(1 for _ in open(steps_path))
                if os.path.exists(steps_path) else 0)
        rec.clear()
        rec.update(step_ms=[], gap_ms=[], batch=[], item_ms={},
                   best_epochs=[], ngp_train_reads=[], epoch=None)
        kernels.reset_launches()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            rec["start_bytes"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        out, ms = timed(lambda: main(argv)) if on_card else (main(argv), 0.0)
        mine = dict(rec, wall_s=ms / 1e3,
                    launches=dict(kernels.LAUNCHES),
                    peak_bytes=(torch.cuda.max_memory_allocated()
                                if on_card else 0))
        mine.pop("last_end", None)
        lines = [json.loads(x) for x in open(steps_path)][done:]
        mine["phase_s"] = {}
        for x in lines:
            mine["phase_s"][x["tag"]] = mine["phase_s"].get(x["tag"], 0.0) \
                + x["seconds"]
        return out, mine, lines

    def metrics(run):
        records = [json.loads(x) for x in open(os.path.join(
            run, "metrics.jsonl"))]
        for r in records:
            for k, v in r.items():
                if "loss" in k or k.startswith(("val", "test")):
                    assert math.isfinite(v), (run, k, v)
        return records

    def series(records, key):
        return [r[key] for r in records if key in r]

    def write_exp(exp, path):
        with open(path, "w") as f:
            f.write("\n".join(_yaml(exp)) + "\n")
        assert load_yaml(path) == exp
        return path

    def summary(r):
        """The medians of a call's step, gap and item times."""
        med = lambda xs: statistics.median(xs) if xs else None
        return {"step_ms_median": med(r["step_ms"]),
                "gap_ms_median": med(r["gap_ms"]),
                "item_ms_median": {m: med(v) for m, v in r["item_ms"].items()}}

    saved_env = os.environ.get("ENV_WORKSTATION_NAME")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loops_") as tmp:
        t0 = time.perf_counter()
        env = {"results": os.path.join(tmp, "results"),
               "scannet": os.path.join(tmp, "scans"),
               "scannet_frames_25k": os.path.join(tmp, "frames_25k")}
        with open(os.path.join(tmp, "env.yml"), "w") as f:
            f.write("\n".join(_yaml(env)) + "\n")
        os.environ["ENV_WORKSTATION_NAME"] = os.path.join(tmp, "env")
        f25k = env["scannet_frames_25k"]
        try:
            write_synthetic_25k_dir(f25k, n_scenes=LOOP_25K_SCENES,
                                    n_frames_per_scene=LOOP_25K_FRAMES,
                                    H=hw_25k[0], W=hw_25k[1], frame_gain=0.1,
                                    pixel_noise=0.02)
            exp = load_yaml(os.path.join(REPO, PRETRAIN_EXP))
            exp["data_module"]["root"] = f25k
            split_path, _ = create_split.main([
                "--config", write_exp(exp, os.path.join(tmp, "split.yml")),
                "--seed", str(seed)])
            res["split"] = {k: len(v)
                            for k, v in load_split(split_path).items()}
            write_synthetic_scene_dir(env["scannet"], STAGE_SCENE,
                                      n_frames=LOOP_FRAMES, H=hw[0], W=hw[1])
            res["setup_s"] = time.perf_counter() - t0

            SegTrainer.train_step = train_step
            SegTrainer.init = init
            JointTrainer.init = joint_init
            ScanNet.__getitem__ = timed_item("item")
            ScanNetNGP.__getitem__ = timed_item("ngp_item")
            ScanNetNGP._read_rgb = ngp_rgb
            pretrain_loop.run_epoch = run_epoch
            pretrain_loop.save_deeplab = save_deeplab

            # (a) the pretrain, then its resume
            exp["trainer"]["max_epochs"] = PRETRAIN_EPOCHS[0]
            exp["trainer"]["profiler"] = True
            if tuple(hw) != SEG_HW:
                exp["output_size"] = list(hw)
            assert exp["lr_scheduler"]["poly_cfg"]["max_epochs"] == 150
            pre_run = os.path.join(env["results"], exp["general"]["name"])
            argv = ["--exp", os.path.join(tmp, "pretrain.yml"), "--seed",
                    str(seed), "--device", device.type]
            write_exp(exp, argv[1])
            (trainer, best), pre, lines = cli(pretrain.main, argv, pre_run)
            tags = [x["tag"] for x in lines]
            assert tags == list(PRETRAIN_PHASES) * PRETRAIN_EPOCHS[0] + [
                "test"], tags
            records = metrics(pre_run)
            lrs = series(records, "lr")
            p = exp["lr_scheduler"]["poly_cfg"]
            assert lrs == [poly_lr_factor(e, 150, p["power"],
                                          float(exp["optimizer"]["lr"]),
                                          float(p["target_lr"]))
                           for e in range(PRETRAIN_EPOCHS[0])], lrs
            assert len(series(records, "train/loss")) == PRETRAIN_EPOCHS[0]
            val = series(records, "val/mean_IoU")
            assert pre["best_epochs"] and pre["best_epochs"][0] == 0
            assert best == max(val), (best, val)
            best_ckpt = os.path.join(pre_run, "best_ckpt")
            last = load_tree(os.path.join(pre_run, "last_ckpt"))
            assert last["epoch"] == PRETRAIN_EPOCHS[0]
            assert last["best_miou"] == best
            # a short last batch, padded: 4 images every step
            assert set(pre["batch"]) == {4}, pre["batch"]
            assert not any(pre["launches"].values()), pre["launches"]
            pre["epoch_s"] = [x["seconds"] for x in lines
                              if x["tag"] == "train_epoch"]
            trace = os.path.join(pre_run, "torch_trace", "trace.json")
            pre["traced_epoch_device_ms"] = _trace_device_ms(trace)
            pre["traced_epoch_idle_share"] = 1.0 - \
                pre["traced_epoch_device_ms"] / (1e3 * pre["epoch_s"][0])
            pre["losses"] = series(records, "train/loss")
            pre["val_mean_IoU"] = val
            pre["lr"] = lrs
            del trainer, last

            exp["trainer"]["max_epochs"] = PRETRAIN_EPOCHS[1]
            exp["trainer"]["resume_from_checkpoint"] = True
            write_exp(exp, argv[1])
            (trainer, best2), pre2, lines2 = cli(pretrain.main, argv,
                                                 pre_run)
            assert [x["tag"] for x in lines2] == list(PRETRAIN_PHASES) + [
                "test"], lines2
            assert [x.get("epoch") for x in lines2][:3] == \
                [PRETRAIN_EPOCHS[0]] * 3
            val2 = series(metrics(pre_run), "val/mean_IoU")
            assert len(val2) == PRETRAIN_EPOCHS[1]
            assert best2 == max(best, val2[-1]), (best, best2, val2)
            last = load_tree(os.path.join(pre_run, "last_ckpt"))
            assert last["epoch"] == PRETRAIN_EPOCHS[1]
            assert last["best_miou"] == best2
            _assert_same_bits(last["model"], trainer.model.state_dict())
            _assert_same_bits(last["optimizer"],
                              trainer.optimizer.state_dict())
            pre2["val_mean_IoU"] = val2
            pre2["epoch_s"] = [x["seconds"] for x in lines2
                               if x["tag"] == "train_epoch"]
            res["pretrain"], res["pretrain_resume"] = pre, pre2
            del trainer, last

            # (b) the NeRF-only stage, its seg net from best_ckpt
            stage_exp = load_yaml(os.path.join(REPO, STAGE_EXP))
            stage_exp["general"]["checkpoint_load"] = best_ckpt
            stage_exp["val_scenes"] = [STAGE_SCENE]
            stage_exp["trainer"]["profiler"] = True
            if tuple(hw) != SEG_HW:
                stage_exp["output_size"] = list(hw)
            stage_run = os.path.join(env["results"],
                                     stage_exp["general"]["name"])
            argv = ["--exp", write_exp(stage_exp, os.path.join(
                tmp, "nerf_only.yml")), "--exp_name", NERF_ONLY,
                "--nerf_train_epoch", str(NERF_ONLY_EPOCHS),
                "--joint_train_epoch", "0", "--seed", str(seed),
                "--device", device.type]
            _, stage, lines = cli(train_joint.main, argv, stage_run)
            assert [x["tag"] for x in lines] == list(NERF_ONLY_PHASES), lines
            metrics(stage_run)
            best_state = load_deeplab(best_ckpt)
            _assert_same_bits(stage["seg_at_start"], best_state,
                              "stage start")
            if on_card:
                missing = [k for k in STAGE_KERNELS
                           if stage["launches"][k] <= 0]
                assert not missing, f"not launched in the stage: {missing}"
            train_set = ScanNetNGP(env["scannet"], [STAGE_SCENE],
                                   prev_exp_name=NERF_ONLY,
                                   output_size=tuple(hw))
            dumps = train_set.image_nerf_pths + train_set.label_nerf_pths
            assert len(train_set) == LOOP_FRAMES - LOOP_FRAMES // 5
            assert all(os.path.isfile(p) for p in dumps), dumps
            stage.pop("seg_at_start")
            res["nerf_only"] = stage

            # (c) the finetune on the stage's renders, then with replay
            fexp = load_yaml(os.path.join(REPO, FINETUNE_EXP))
            fexp["general"]["checkpoint_load"] = best_ckpt
            fexp["trainer"]["max_epochs"] = FINETUNE_EPOCHS[0]
            fexp["trainer"]["profiler"] = True
            if tuple(hw) != SEG_HW:
                fexp["output_size"] = list(hw)
            name = fexp["general"]["name"]
            for cl in (False, True):
                if cl:
                    fexp["general"]["name"] = name + "_cl"
                    fexp["trainer"]["max_epochs"] = FINETUNE_EPOCHS[1]
                    fexp["cl"].update({"active": True, "ngp_25k_ratio": 1,
                                       "25k_fraction": 1.0})
                run = os.path.join(env["results"], fexp["general"]["name"])
                argv = ["--exp", write_exp(fexp, os.path.join(
                    tmp, "finetune.yml")), "--prev_exp_name", NERF_ONLY,
                    "--seed", str(seed), "--device", device.type]
                fine_trainer, fine, lines = cli(train_finetune.main, argv,
                                                run)
                epochs = fexp["trainer"]["max_epochs"]
                assert [x["tag"] for x in lines] == [
                    "val_pre", "test_25k_pre"] + ["train_epoch",
                                                  "last_ckpt"] * epochs + [
                    "val", "test_25k_post", "deeplab_ckpt"], lines
                _assert_same_bits(fine["seg_at_start"], best_state,
                                  "finetune start")
                fine.pop("seg_at_start")
                reads = fine.pop("ngp_train_reads")
                assert sorted(set(reads)) == sorted(
                    train_set.image_nerf_pths), reads
                assert len(reads) == epochs * (len(train_set) // 4 * 4)
                assert set(fine["batch"]) == {8 if cl else 4}, fine["batch"]
                assert not any(fine["launches"].values()), fine["launches"]
                records = metrics(run)
                logged = sorted({k for r in records for k in r
                                 if k.startswith(("val", "test/25k_"))})
                assert logged == sorted(
                    [f"{v}/{m}_{STAGE_SCENE}" for v in ("val_pre", "val")
                     for m in ("mean_IoU", "total_accuracy")]
                    + [f"test/25k_{m}_{t}" for m in ("mean_IoU",
                                                     "total_accuracy",
                                                     "mean_accuracy")
                       for t in ("pre", "post")]), logged
                assert os.path.isdir(os.path.join(run, "deeplab_ckpt"))
                _assert_same_bits(load_deeplab(os.path.join(
                    run, "deeplab_ckpt")), fine_trainer.model.state_dict())
                fine["val_frames"] = LOOP_FRAMES // 5
                fine["val_ms_a_frame"] = 1e3 * fine["phase_s"]["val"] \
                    / fine["val_frames"]
                fine["losses"] = series(records, "train/loss")
                res["finetune_cl" if cl else "finetune"] = fine
                del fine_trainer
        finally:
            SegTrainer.train_step = real["train_step"]
            SegTrainer.init = real["init"]
            JointTrainer.init = real["joint_init"]
            ScanNet.__getitem__ = real["item"]
            ScanNetNGP.__getitem__ = real["ngp_item"]
            ScanNetNGP._read_rgb = real["ngp_rgb"]
            pretrain_loop.run_epoch = real["run_epoch"]
            pretrain_loop.save_deeplab = real["save_deeplab"]
            if saved_env is None:
                os.environ.pop("ENV_WORKSTATION_NAME", None)
            else:
                os.environ["ENV_WORKSTATION_NAME"] = saved_env
    for key in ("pretrain", "pretrain_resume", "nerf_only", "finetune",
                "finetune_cl"):
        res[key].update(summary(res[key]))
    pre, pre2 = res["pretrain"], res["pretrain_resume"]
    log(f"  {card}: 25k split {res['split']} of {hw_25k[0]}x{hw_25k[1]} "
        f"frames, a room of {LOOP_FRAMES} frames (setup "
        f"{res['setup_s']:.2f} s)")
    log(f"  pretrain, {PRETRAIN_EPOCHS[0]} epochs: {pre['wall_s']:.2f} s "
        f"wall, epochs {pre['epoch_s']} s (the first traced: device busy "
        f"{pre['traced_epoch_device_ms']:.1f} ms, idle share "
        f"{pre['traced_epoch_idle_share']:.3f}), step "
        f"{pre['step_ms_median']:.2f} ms median of {len(pre['step_ms'])}, "
        f"wait for the loader {pre['gap_ms_median']:.2f} ms median, a 25k "
        f"item on the loader's thread {pre['item_ms_median']} ms, peak "
        f"{pre['peak_bytes'] / 2**30:.2f} GiB; best_ckpt at epochs "
        f"{pre['best_epochs']}, val mIoU {pre['val_mean_IoU']}, losses "
        f"{pre['losses']}; phases " + ", ".join(
            f"{k} {v:.3f}" for k, v in pre["phase_s"].items()))
    log(f"  pretrain resumed to {PRETRAIN_EPOCHS[1]}: {pre2['wall_s']:.2f} s "
        f"wall, epoch {pre2['epoch_s']} s, best_ckpt at "
        f"{pre2['best_epochs']}, val mIoU {pre2['val_mean_IoU']}, peak "
        f"{pre2['peak_bytes'] / 2**30:.2f} GiB")
    st = res["nerf_only"]
    log(f"  NeRF-only stage: {st['wall_s']:.2f} s wall, peak "
        f"{st['peak_bytes'] / 2**30:.2f} GiB; phases " + ", ".join(
            f"{k} {v:.3f}" for k, v in st["phase_s"].items()))
    log(f"    launches: { {k: v for k, v in st['launches'].items() if v} }")
    for key in ("finetune", "finetune_cl"):
        ft = res[key]
        log(f"  {key}: {ft['wall_s']:.2f} s wall, step "
            f"{ft['step_ms_median']:.2f} ms median of {len(ft['step_ms'])} "
            f"(batch {ft['batch'][0]}), wait for the loader "
            f"{ft['gap_ms_median']:.2f} ms, items on the loader's thread "
            f"{ft['item_ms_median']} ms, val {ft['val_ms_a_frame']:.2f} "
            f"ms a batch-1 frame (decode included), peak "
            f"{ft['peak_bytes'] / 2**30:.2f} GiB, losses {ft['losses']}; "
            "phases " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in ft["phase_s"].items()))
    return res


# ------------------------------------------------------------ opt-in paths
# the reference-parity stage: one_step_joint/s00_lr1e-5.yml with its
# renderer block deleted and nerf: {use_occupancy: false, 16 × 2}
DENSE_FRAMES = 8  # a room of 240×320 frames (6 train, 2 val)
DENSE_EPOCHS = (1, 1)  # NeRF fit, joint
# the dense stage's path: every kernel but the grid's three
# (on the card's defaults its renders and steps encode through their packed
# tables: pack_table and hash_encode_packed_fwd, never hash_encode_fwd)
DENSE_KERNELS = ("stratified_placement", "pack_table",
                 "hash_encode_packed_fwd", "hash_encode_bwd", "mlp_fwd",
                 "mlp_bwd", "importance_resample", "composite_fwd",
                 "composite_bwd")
GRID_KERNELS = ("occ_placement", "occ_grid_update", "hash_encode_sampled")
# what a probe-placement render launches besides its coarse placement
# (occ_placement with a grid, stratified_placement without): on the card's
# defaults the probe and the exact pass both encode through the render's
# packed table (hash_encode_packed_fwd's probe and exact modes), packed
# anew in the frame (fresh_frame)
PROBE_KERNELS = ("pack_table", "hash_encode_packed_fwd",
                 "importance_resample", "mlp_fwd", "composite_fwd")
# what the exact refresh launches, and what it must not
EXACT_REFRESH_KERNELS = ("hash_encode_fwd", "mlp_fwd", "occ_grid_update")
DENSE_STEP_TIMED = 4  # dense steps timed after the compared one
SEG_BF16_CALLS = 6  # timed eval forwards and steps a dtype
# a fresh R101's logits sit near ties: bf16 moves labels. JAX's own bf16
# forward of a fresh full-width R101 agrees with its f32 one on 0.976 of
# the pixels, logits 2.0e-2 of their largest (96×128 on the CPU,
# tests/test_torch_opt_in.py::test_seg_bf16_r101_labels_as_jax): the card's
# bf16 against its f32 is held to 0.98 and 3e-2; from below, its logits
# must lie at least 1e-3 of their largest from the f32 ones (a quarter of
# a bf16 ulp there; a net computing in f32 lies at 0)
SEG_BF16_LABELS, SEG_BF16_LOGITS = 0.98, 3e-2
SEG_BF16_LOGITS_MIN = 1e-3


def dense_stage(device, seed, card, res, hw=SEG_HW):
    """Phase 13 (a): the reference-parity stage through the port's
    train_joint CLI (main(argv), in this process, TF32 on as the CLI sets
    it): cfg/exp/one_step_joint/s00_lr1e-5.yml read by the port's loader,
    its renderer block deleted (the trainer's RenderConfig(): 256 + 256)
    and nerf: {use_occupancy: false, n_levels: 16, n_features: 2}, on a
    synthetic room of DENSE_FRAMES frames of 240×320 with a seeded
    full-width DeepLabV3-R101 as its checkpoint; --nerf_train_epoch 1
    --joint_train_epoch 1; test renders and predict dumps at 256 + 256
    without early stop. Counts zeroed before, read after: the eight path
    kernels launched, the grid's three never. Checks: every logged loss
    finite; no grid returned or saved; a nerf_ckpt frame rendered with the
    kernels and inside plain_versions() agrees (labels >= 0.99, mean
    |Δrgb| <= 1e-3, mean |Δdepth| <= 1e-2); a first dense training step
    of the stage's model at its init on the kernel path within 2e-3 of
    the plain path's from the same state and draws (each loss part), then
    DENSE_STEP_TIMED steps timed (ms, rays/s, peak). Returns the model
    loaded from nerf_ckpt."""
    import copy as copy_mod
    import gc
    import tempfile

    import numpy as np

    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.config import load_yaml
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.data.synthetic import (
        make_synthetic_scene, write_synthetic_scene_dir)
    from ucsa_neural_rendering_tpu_torch.models import DeepLabV3
    from ucsa_neural_rendering_tpu_torch.scripts import train_joint
    from ucsa_neural_rendering_tpu_torch.train import (NeRFTrainer,
                                                       joint_loop)
    from ucsa_neural_rendering_tpu_torch.train.checkpoints import (
        load_tree, save_deeplab)

    H, W = hw
    saved_env = os.environ.get("ENV_WORKSTATION_NAME")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dense_") as tmp:
        t0 = time.perf_counter()
        env = {"results": os.path.join(tmp, "results"),
               "scannet": os.path.join(tmp, "scans"),
               "scannet_frames_25k": os.path.join(tmp, "frames_25k")}
        write_synthetic_scene_dir(env["scannet"], STAGE_SCENE,
                                  n_frames=DENSE_FRAMES, H=H, W=W,
                                  color_ext=".png")
        ckpt = os.path.join(tmp, "pretrained_deeplab")
        save_deeplab(ckpt, DeepLabV3(
            num_classes=SEG_CLASSES, device="cpu",
            generator=torch.Generator().manual_seed(seed)).state_dict())
        res["setup_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "env.yml"), "w") as f:
            f.write("\n".join(_yaml(env)) + "\n")
        os.environ["ENV_WORKSTATION_NAME"] = os.path.join(tmp, "env")
        exp = load_yaml(os.path.join(REPO, STAGE_EXP))
        del exp["renderer"]
        exp["nerf"] = {"use_occupancy": False, "n_levels": DENSE_LEVELS,
                       "n_features": DENSE_FEATURES}
        exp["general"]["checkpoint_load"] = ckpt
        exp["val_scenes"] = [STAGE_SCENE]
        exp["trainer"]["profiler"] = True
        exp["output_size"] = list(hw)
        exp_path = os.path.join(tmp, "dense.yml")
        with open(exp_path, "w") as f:
            f.write("\n".join(_yaml(exp)) + "\n")
        assert load_yaml(exp_path) == exp
        run = os.path.join(env["results"], exp["general"]["name"])
        argv = ["--exp", exp_path, "--exp_name", "dense",
                "--nerf_train_epoch", str(DENSE_EPOCHS[0]),
                "--joint_train_epoch", str(DENSE_EPOCHS[1]),
                "--seed", str(seed)] + \
            ([] if device.type == "cuda" else ["--device", device.type])
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            (trainer, grid), ms = timed(lambda: train_joint.main(argv))
            res["launches"] = dict(kernels.LAUNCHES)
            res["wall_s"] = ms / 1e3
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
            missing = [k for k in DENSE_KERNELS if res["launches"][k] <= 0]
            assert not missing, f"not launched in the dense stage: {missing}"
            stray = [k for k in GRID_KERNELS if res["launches"][k]]
            assert not stray, f"grid kernels in the dense stage: {stray}"
            assert grid is None and not trainer.use_occupancy
            assert (trainer.test_cfg.num_steps,
                    trainer.test_cfg.upsample_steps) == (DENSE_STEPS,
                                                         DENSE_STEPS)
            assert not trainer.test_cfg.early_stop
            assert trainer.predict_cfg == trainer.test_cfg == trainer.cfg
            res["budgets"] = trainer.budget_summary()
            steps = [json.loads(x) for x in open(os.path.join(
                run, "profile_steps.jsonl"))]
            res["phase_s"] = {}
            for x in steps:
                res["phase_s"][x["tag"]] = res["phase_s"].get(x["tag"], 0) \
                    + x["seconds"]
            records = [json.loads(x) for x in open(os.path.join(
                run, "metrics.jsonl"))]
            losses = [(k, v) for r in records for k, v in r.items()
                      if "loss" in k]
            assert losses and all(math.isfinite(v) for _, v in losses)
            res["losses"] = losses
            for name in ("deeplab_ckpt", "nerf_ckpt", "last_ckpt"):
                assert os.path.isdir(os.path.join(run, name)), name
            assert "occ_grid" not in load_tree(os.path.join(run,
                                                            "last_ckpt"))
            nerf_ckpt = load_tree(os.path.join(run, "nerf_ckpt"),
                                  map_location=device)
            assert nerf_ckpt.get("occ_grid") is None
            scene_exp = os.path.join(env["scannet"], STAGE_SCENE, "dense")
            n_dumps = len(os.listdir(os.path.join(scene_exp, "nerf_label")))
            res["predict_frames"] = n_dumps
            res["predict_ms_per_frame"] = \
                1e3 * res["phase_s"]["predict_final"] / n_dumps
            seg_model = trainer.seg.model
            del trainer
        finally:
            if saved_env is None:
                os.environ.pop("ENV_WORKSTATION_NAME", None)
            else:
                os.environ["ENV_WORKSTATION_NAME"] = saved_env

    # a nerf_ckpt frame, kernels against plain, at the stage's 256 + 256
    fresh = joint_loop.nerf_model_from_exp(
        exp, SEG_CLASSES, device, torch.Generator().manual_seed(seed + 1))
    fresh.load_state_dict(nerf_ckpt["params"])
    tr = NeRFTrainer(fresh, image_hw=hw, device=device)
    rays = get_rays(look_at(POSES[0]), INTRINSICS, H, W, device=device)
    frame = lambda: fresh_frame(tr, None, rays, None)
    frame()  # warm-up
    kernels.reset_launches()
    out, res["frame_ms"] = timed(frame)
    res["frame_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    with kernels.plain_versions():
        ref, res["frame_plain_ms"] = timed(frame)
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    res["frame_agreement"] = agree = _frame_agreement(out, ref)
    assert agree["labels"] >= 0.99 and agree["rgb_mean"] <= 1e-3 and \
        agree["depth_mean"] <= 1e-2, agree
    del tr, out, ref

    # a first dense step at the stage's model init, kernels against plain
    # from the same state and draws; then steps timed
    fmodel = joint_loop.nerf_model_from_exp(
        exp, SEG_CLASSES, device, torch.Generator().manual_seed(seed))
    frames, intr = make_synthetic_scene(n_frames=1, H=H, W=W)
    f0 = frames[0]
    batch = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in (("pose", f0["pose"]), ("intrinsics", intr),
                          ("image", f0["image"]), ("label", f0["label"]),
                          ("depth", f0["depth"]),
                          ("one_m_to_scene_uom", np.float32(1.0)))}
    trainers = [NeRFTrainer(m, n_rays=N_RAYS, image_hw=hw, device=device)
                for m in (fmodel, copy_mod.deepcopy(fmodel))]
    gen = torch.Generator(device).manual_seed(seed + 2)
    draws = trainers[0].draw(gen)
    kernels.reset_launches()
    parts_k = {k: float(v) for k, v in
               trainers[0].train_step(batch, None, None, draws).items()}
    step_launches = dict(kernels.LAUNCHES)
    with kernels.plain_versions():
        parts_p = {k: float(v) for k, v in
                   trainers[1].train_step(batch, None, None, draws).items()}
    res["step1_loss_rel"] = loss_err(parts_k, parts_p)
    res["step1_losses"] = parts_k
    res["step_launches"] = {k: v for k, v in step_launches.items() if v}
    assert all(math.isfinite(v) for v in parts_k.values()), parts_k
    assert res["step1_loss_rel"] <= 2e-3, (parts_k, parts_p)
    del trainers[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = [timed(lambda: trainers[0].train_step(batch, gen, None))[1]
               for _ in range(DENSE_STEP_TIMED)]
    res["step_ms"] = step_ms
    res["step_peak_bytes"] = torch.cuda.max_memory_allocated()
    res["rays_per_s"] = N_RAYS / (statistics.median(step_ms) / 1e3)
    del trainers, fmodel, seg_model
    log(f"  {card}: dense stage ({res['budgets']}) of {DENSE_EPOCHS[0]} + "
        f"{DENSE_EPOCHS[1]} epochs over {DENSE_FRAMES} frames: "
        f"{res['wall_s']:.2f} s wall (setup {res['setup_s']:.2f} s before "
        f"it), peak {res['peak_bytes'] / 2**30:.2f} GiB; phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["phase_s"].items()))
    log(f"  predict {res['predict_ms_per_frame']:.2f} ms a frame with its "
        f"PNGs; launches {res['launches']}")
    log(f"  nerf_ckpt frame at {DENSE_STEPS} + {DENSE_STEPS}: kernel "
        f"{res['frame_ms']:.2f} ms, plain {res['frame_plain_ms']:.2f} ms; "
        + " ".join(f"{k} {v:.3e}" for k, v in agree.items())
        + f"; launches {res['frame_launches']}")
    log(f"  dense step ({N_RAYS} rays × {2 * DENSE_STEPS}): step 1 losses "
        f"within {res['step1_loss_rel']:.3e} of plain; "
        f"{[round(t, 2) for t in step_ms]} ms, {res['rays_per_s']:.0f} "
        f"rays/s, peak {res['step_peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{res['step_launches']}")
    return fresh


def _frame_agreement(out, ref):
    """render_image outputs against the plain path's: |Δ| of rgb and depth,
    the share of equal argmax labels."""
    rgb = (out["nerf_rgb"] - ref["nerf_rgb"]).abs()
    dep = (out["nerf_depth"] - ref["nerf_depth"]).abs()
    for k in ("nerf_rgb", "nerf_semantics_raw", "nerf_depth"):
        assert torch.isfinite(out[k]).all(), k
    return dict(rgb_max=rgb.max().item(), rgb_mean=rgb.mean().item(),
                depth_max=dep.max().item(), depth_mean=dep.mean().item(),
                labels=(out["nerf_semantics"] == ref["nerf_semantics"]
                        ).float().mean().item())


def probe_renders(model, grid, cfgs, device, res, trained=None, seed=0):
    """Phase 13 (b): probe placement on phase 4's model, full 240×320
    frames through NeRFTrainer.render_image: the test config with
    probe_placement (16 probes → 32 exact samples) with the grid, without
    it, and under the test config's early stop with the grid; each on the
    kernel path (counts zeroed before, read after: PROBE_KERNELS, the
    probe through the render's fp8 packed table packed anew in the frame,
    and occ_placement or stratified_placement launched) and on the plain
    path, held as phase 4 holds its frames.
    A probe's sampled corner is a hash of its position's f32 bits, and
    occ_placement's z differ from its plain version's in their last bits
    (its warp scans sum in another order): on phase 4's random table, a
    last-bit move draws another corner of a cell whose corners are
    unrelated, so with a grid the plain path keeps the kernel's probe
    placement (every other kernel plain; only occ_placement launches),
    so that both draw the same corners. Without a grid the placement is
    bit-equal and the whole path is plain. `trained` (the dense stage's
    nerf_ckpt, a table grown smoothly from U(±1e-4) by training) with a
    grid refreshed from it over all its slabs: the probe-with-grid frame
    against the whole plain path, occ_placement plain too, held the
    same way: on a smooth field another corner of a cell moves the probe
    density little, and the end-to-end row witnesses the occ_placement
    call itself."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    rays = get_rays(look_at(POSES[1]), INTRINSICS, 240, 320, device=device)
    flat = replace(cfgs["test"], probe_placement=True, early_stop=False)
    runs = [("probe grid", model, flat, grid, ("occ_placement",)),
            ("probe no grid", model, flat, None, ()),
            ("probe grid early stop", model,
             replace(cfgs["test"], probe_placement=True), grid,
             ("occ_placement",))]
    if trained is not None:
        tr = NeRFTrainer(trained, image_hw=(240, 320), device=device)
        tgrid = tr.init_occupancy()
        gen = torch.Generator(device).manual_seed(seed)
        for _ in range(tr.occ_cfg.refresh_slabs):
            tgrid = tr.update_occupancy(tgrid, gen)
        res["trained_grid_occupied"] = (
            tgrid > flat.occ_density_threshold).float().mean().item()
        runs.append(("probe grid, trained field, all plain", trained, flat,
                     tgrid, ()))
        log(f"  trained field's grid: {res['trained_grid_occupied']:.4f} of "
            f"the cells occupied")
    rows = {}
    for name, m, cfg, g, shared in runs:
        tr = NeRFTrainer(m, cfg, image_hw=(240, 320), device=device)
        frame = lambda: fresh_frame(tr, None, rays, g)
        frame()  # warm-up
        kernels.reset_launches()
        out, ms = timed(frame)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        need = PROBE_KERNELS + (() if not PROBE_KERNELS else (
            "occ_placement" if g is not None else "stratified_placement",))
        assert all(k in launches for k in need), (name, launches)
        plain = [n for _, n, _ in kernels._CALL_SITES if n not in shared]
        kernels.reset_launches()
        with kernels.plain_versions(*plain):
            ref, plain_ms = timed(frame)
        assert not any(v for k, v in kernels.LAUNCHES.items()
                       if k not in shared), kernels.LAUNCHES
        agree = _frame_agreement(out, ref)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, launches=launches,
                          agreement=agree, plain_keeps=list(shared))
        log(f"  {name}: kernel {ms:.2f} ms, plain {plain_ms:.2f} ms; "
            + " ".join(f"{k} {v:.3e}" for k, v in agree.items())
            + f"; launches {launches}")
        assert agree["labels"] >= 0.99 and agree["rgb_mean"] <= 1e-3 and \
            agree["depth_mean"] <= 1e-2, (name, agree)
    res["probe"] = rows


@torch.no_grad()
def exact_refresh(model, grid, device, seed, res):
    """Phase 13 (c): one refresh of slab 0 of the 128³ grid with
    OccupancyConfig(probe_sampled=False), the exact density (hash_encode_fwd
    + mlp_fwd, two 262,144-point chunks, then occ_grid_update), on the
    kernel path and inside plain_versions() with the same jitter: the
    refreshed slab within 1e-2 relative on >= 0.999 of its cells (sigma is
    exp of a bf16 logit, and the MLP kernels round an element to the other
    bf16 neighbour now and then) and within 5e-2 on all, the rest of the
    grid equal (decay only); hash_encode_sampled never launched."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import OccupancyConfig
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer

    tr = NeRFTrainer(model, image_hw=(240, 320), device=device)
    tr.occ_cfg = OccupancyConfig(resolution=grid.shape[0],
                                 probe_sampled=False)
    r = grid.shape[0]
    cells = r ** 3 // tr.occ_cfg.refresh_slabs
    jitter = torch.rand((cells, 3), generator=torch.Generator(
        device).manual_seed(seed), device=device)
    tr._occ_slab = 0
    tr.update_occupancy(grid, jitter=jitter)  # warm-up
    tr._occ_slab = 0
    kernels.reset_launches()
    out, ms = timed(lambda: tr.update_occupancy(grid, jitter=jitter))
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert all(k in launches for k in EXACT_REFRESH_KERNELS), launches
    assert launches.get("occ_grid_update", 0) <= 1 and \
        "hash_encode_sampled" not in launches, launches
    tr._occ_slab = 0
    kernels.reset_launches()
    with kernels.plain_versions():
        ref, plain_ms = timed(lambda: tr.update_occupancy(grid,
                                                          jitter=jitter))
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    o, p = out.reshape(-1), ref.reshape(-1)
    rel_d = (o[:cells] - p[:cells]).abs() / p[:cells].abs()
    close = (rel_d <= 1e-2).float().mean().item()
    assert close >= 0.999 and rel_d.max().item() <= 5e-2, \
        (close, rel_d.max().item())
    assert torch.equal(o[cells:], p[cells:])
    res["exact_refresh"] = dict(ms=ms, plain_ms=plain_ms, launches=launches,
                                within_1e2=close,
                                max_rel=rel_d.max().item())
    log(f"  exact refresh of a slab ({cells} cells): kernel {ms:.2f} ms, "
        f"plain {plain_ms:.2f} ms; within 1e-2 on {close:.5f} of the cells, "
        f"max {rel_d.max().item():.3e}; launches {launches}")


@contextlib.contextmanager
def seg_dtypes(model):
    """Inside the block, record what a DeepLabV3 computes in: the output
    dtypes of its convolutions and BNs (forward hooks) and of the logits
    it hands to the bilinear resize. Yields the record."""
    from torch import nn

    from ucsa_neural_rendering_tpu_torch.models import deeplabv3 as tdl
    seen = {"conv": set(), "bn": set(), "logits": set()}
    hooks = []
    for m in model.modules():
        kind = "conv" if isinstance(m, nn.Conv2d) else \
            "bn" if isinstance(m, nn.BatchNorm2d) else None
        if kind:
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, kind=kind: seen[kind].add(out.dtype)))
    resize = tdl.resize_bilinear

    def spy(x, hw):
        seen["logits"].add(x.dtype)
        return resize(x, hw)

    tdl.resize_bilinear = spy
    try:
        yield seen
    finally:
        tdl.resize_bilinear = resize
        for h in hooks:
            h.remove()


# device kernels of a convolution (cuDNN's fprop / dgrad / wgrad engines
# and its direct and implicit-GEMM fallbacks) and the marks of a bf16 one
CONV_MARKS = ("fprop", "dgrad", "wgrad", "convolve", "conv2d")
BF16_MARKS = ("bf16", "bfloat16")


def seg_bf16(device, seed, res, out_dir):
    """Phase 13 (d): DeepLabV3-R101 (40 classes) at compute_dtype bf16
    against f32 (TF32 off) on one seeded batch of 4 at 240×320, the same
    weights: eval labels equal on >= SEG_BF16_LABELS of the pixels and
    the logits' largest |Δ| within SEG_BF16_LOGITS of their largest
    magnitude and at least SEG_BF16_LOGITS_MIN of it
    (tests/test_torch_opt_in.py::test_seg_bf16_r101_labels_as_jax: JAX's
    own bf16 R101 agrees with its f32 on 0.976); SegTrainer steps
    (Adam 1e-4) at both dtypes finite, the parameters f32; eval and step
    ms (median of SEG_BF16_CALLS after a warm-up) and a step's peak at
    each dtype. What each computes in, on the card: during an eval and a
    step every convolution and BN writes the compute dtype and the logits
    reach the resize in f32 (seg_dtypes), and in one profiled step
    (profile_run, on the card) the bf16 net's convolutions run in cuDNN
    kernels named bf16, the f32 net's in none; the profile's device busy
    time, its device operations and the top device ops go to the
    record."""
    import gc

    from ucsa_neural_rendering_tpu_torch.models import DeepLabV3
    from ucsa_neural_rendering_tpu_torch.train import SegTrainer

    images, labels = seg_batch(seed, SEG_BATCH, device)
    f32 = DeepLabV3(num_classes=SEG_CLASSES, device=device,
                    generator=torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in f32.state_dict().items()}
    out = {}
    with tf32(False):
        for name, dtype in (("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
            model = DeepLabV3(num_classes=SEG_CLASSES, device=device,
                              compute_dtype=dtype)
            model.load_state_dict(state, strict=True)
            tr = SegTrainer(model, {"name": "Adam", "lr": SEG_LR},
                            device=device)
            tr.init()
            with seg_dtypes(model) as seen:
                tr.eval_step(images)
            evals = [timed(lambda: tr.eval_step(images))
                     for _ in range(SEG_BF16_CALLS)]
            gen = torch.Generator(device).manual_seed(seed)
            with seg_dtypes(model) as seen_step:
                tr.train_step(images, labels, SEG_LR, gen)  # warm-up
            assert seen == seen_step == {"conv": {dtype}, "bn": {dtype},
                                         "logits": {torch.float32}}, \
                (name, seen, seen_step)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = [timed(lambda: tr.train_step(images, labels, SEG_LR,
                                                 gen))
                     for _ in range(SEG_BF16_CALLS)]
            peak = torch.cuda.max_memory_allocated()
            loss = float(steps[-1][0][0])
            assert math.isfinite(loss), (name, loss)
            prof = None
            if device.type == "cuda":
                _, prof = profile_run(
                    lambda: tr.train_step(images, labels, SEG_LR, gen),
                    out_dir, f"profile_seg_compute_{name}_step.txt",
                    by_name=True)
                ops = prof.pop("by_name")
                conv = {k: v for k, v in ops.items()
                        if any(m in k for m in CONV_MARKS)}
                conv_bf16 = {k: v for k, v in conv.items()
                             if any(m in k for m in BF16_MARKS)}
                assert bool(conv_bf16) == (dtype == torch.bfloat16), \
                    (name, sorted(conv)[:8])
                prof.update(
                    conv_ms=sum(conv.values()),
                    conv_bf16_ms=sum(conv_bf16.values()),
                    top=sorted(ops.items(), key=lambda kv: -kv[1])[:10])
            assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                       for p in model.parameters()), name
            out[name] = dict(
                preds=evals[0][0][0], logits=evals[0][0][1], loss=loss,
                eval_ms=statistics.median(ms for _, ms in evals),
                step_ms=statistics.median(ms for _, ms in steps),
                step_peak_bytes=peak, step_profile=prof)
            del model, tr
    labels_equal = (out["bf16"]["preds"] == out["f32"]["preds"]
                    ).float().mean().item()
    logits_rel = ((out["bf16"]["logits"] - out["f32"]["logits"]).abs().max()
                  / out["f32"]["logits"].abs().max()).item()
    res["seg_bf16"] = dict(
        labels_equal=labels_equal, logits_rel=logits_rel,
        **{f"{k}_{name}": v for name, o in out.items()
           for k, v in o.items() if k not in ("preds", "logits")})
    log(f"  DeepLabV3-R101 batch {SEG_BATCH}, bf16 against f32: labels equal "
        f"on {labels_equal:.5f}, logits {logits_rel:.3e} of their max; eval "
        f"{out['f32']['eval_ms']:.2f} / {out['bf16']['eval_ms']:.2f} ms, "
        f"step {out['f32']['step_ms']:.2f} / {out['bf16']['step_ms']:.2f} "
        f"ms, step peak {out['f32']['step_peak_bytes'] / 2**30:.2f} / "
        f"{out['bf16']['step_peak_bytes'] / 2**30:.2f} GiB, last loss "
        f"{out['f32']['loss']:.4f} / {out['bf16']['loss']:.4f} (f32 / bf16)")
    for name, o in out.items():
        p = o["step_profile"]
        if p is None:
            continue
        log(f"  {name} step profiled: wall {p['wall_ms']:.2f} ms, device busy "
            f"{p['device_busy_ms']:.2f} ms in {p['device_ops']} device ops "
            f"(idle share {p['idle_share']:.3f}); convolutions "
            f"{p['conv_ms']:.2f} ms, {p['conv_bf16_ms']:.2f} of it in bf16 "
            f"kernels; top: " + "; ".join(f"{k[:70]} {v:.2f}"
                                          for k, v in p["top"][:5]))
    assert labels_equal >= SEG_BF16_LABELS and \
        SEG_BF16_LOGITS_MIN <= logits_rel <= SEG_BF16_LOGITS, \
        (labels_equal, logits_rel)


def dense_phase(model, grid, cfgs, device, seed, card, out_dir,
                hw=SEG_HW):
    """Phase 13: the opt-in paths (dense_stage, probe_renders,
    exact_refresh, seg_bf16 above). Returns their records; "launches" are
    the dense stage's. A CPU rehearsal passes a small hw."""
    res = {"card": card, "frames": DENSE_FRAMES, "epochs": DENSE_EPOCHS,
           "exp": STAGE_EXP}
    t0 = time.perf_counter()
    trained = dense_stage(device, seed, card, res, hw)
    probe_renders(model, grid, cfgs, device, res, trained, seed)
    del trained
    exact_refresh(model, grid, device, seed, res)
    seg_bf16(device, seed, res, out_dir)
    res["phase_wall_s"] = time.perf_counter() - t0
    log(f"  phase 13: {res['phase_wall_s']:.1f} s")
    return res


def _assert_same_bits(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_bits(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_bits(x, y, f"{path}.{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.to(b.device), b), path
    else:
        assert a == b, path


# --------------------------------------------------------- packed tables
def _step_states(tr):
    """A trainer's parameters, their gradients and Adam moments after a
    step, by parameter name: {name: (param, grad, exp_avg, exp_avg_sq)}."""
    out = {}
    for n, p in tr.model.named_parameters():
        st = tr.optimizer.state[p]
        out[n] = (p.detach(), p.grad, st["exp_avg"], st["exp_avg_sq"])
    return out


def packed_step(batch, device, seed):
    """Phase 14 (c): one shipped training step (4096 rays, 24 + 8
    proposal-placed samples) with the card's bf16 train packing, against
    the same step with train_packed_max_entries=0, from deep copies of one
    fresh trainer with the same draws. Packing is a relayout of the
    forward: the step's encodes (pack_table + hash_encode_packed_fwd
    against hash_encode_fwd), its losses, the cotangent and points that
    reach hash_encode_bwd, and every parameter, gradient and Adam moment
    after the step (the table's too: hash_encode_bwd adds in a fixed
    order) are bit-equal. Then both steps' device ms (bench.device_ms, in
    turns: packed, unpacked, unpacked, packed), each on its own copy
    stepping on."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer
    shipped = train_config()
    model = SemanticNeRF(**TRAIN_MODEL, device=device,
                         generator=torch.Generator().manual_seed(seed))
    base = NeRFTrainer(model, shipped, n_rays=N_RAYS, image_hw=(240, 320),
                       device=device)
    base.init()
    grid = base.init_occupancy()
    draws = base.draw(torch.Generator(device).manual_seed(seed + 1))
    bwd_kernel = he.hash_encode_bwd

    def step(budget):
        """The step from a copy of base at train_packed_max_entries=budget:
        (loss parts, the encodes' outputs, hash_encode_bwd's inputs, the
        states, the launches)."""
        tr = copy.deepcopy(base)
        tr.cfg = replace(shipped, train_packed_max_entries=budget)
        encodes, bwd_in = [], []
        hook = tr.model.encoder.register_forward_hook(
            lambda m, a, kw, out: encodes.append(out.detach().clone())
            if kw.get("train") else None, with_kwargs=True)

        def recorded_bwd(x01, g, spec, stochastic):
            bwd_in.append((x01.clone(), g.clone()))
            return bwd_kernel(x01, g, spec, stochastic)

        he.hash_encode_bwd = recorded_bwd
        kernels.reset_launches()
        try:
            parts = tr.train_step(batch, None, grid, draws=draws)
            torch.cuda.synchronize()
        finally:
            he.hash_encode_bwd = bwd_kernel
            hook.remove()
        return parts, encodes, bwd_in, _step_states(tr), \
            dict(kernels.LAUNCHES)

    res = {}
    (pp, pe, pb, ps, pl), (up, ue, ub, us, ul) = step(TRAIN_PACK[0]), step(0)
    assert pl["pack_table"] == 1 and pl["hash_encode_packed_fwd"] == 2 \
        and pl["hash_encode_fwd"] == 0 and pl["hash_encode_bwd"] == 2, pl
    assert ul["pack_table"] == 0 and ul["hash_encode_fwd"] == 2 and \
        ul["hash_encode_packed_fwd"] == 0 and ul["hash_encode_bwd"] == 2, ul
    assert all(torch.equal(pp[k], up[k]) for k in up), (pp, up)
    assert len(pe) == len(ue) == 2 and all(
        torch.equal(a, b) for a, b in zip(pe, ue))
    assert len(pb) == len(ub) == 2 and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(pb, ub))
    differ = {n: sum(int(not torch.equal(a, b))
                     for a, b in zip(ps[n], us[n])) for n in us}
    assert not any(differ.values()), differ
    res["kernel"] = dict(
        loss_parts={k: v.item() for k, v in pp.items()},
        states_differing=differ,
        launches_packed={k: v for k, v in pl.items() if v},
        launches_unpacked={k: v for k, v in ul.items() if v})
    log("  (c) packed step against unpacked, hash_encode_bwd's kernel on "
        "both: losses, encodes, hash_encode_bwd's inputs and every "
        "parameter, gradient and Adam moment (the table's too) bit-equal")
    copies = {}
    for name, budget in (("packed", TRAIN_PACK[0]), ("unpacked", 0)):
        copies[name] = copy.deepcopy(base)
        copies[name].cfg = replace(shipped, train_packed_max_entries=budget)
    ms = {name: [] for name in copies}
    for name in ("packed", "unpacked", "unpacked", "packed"):
        ms[name].append(device_ms(
            lambda tr=copies[name]: tr.train_step(batch, None, grid,
                                                  draws=draws),
            iters=10, warmup=2))
    res["device_ms"] = ms
    log(f"  (c) a step's device ms in turns: packed "
        f"{[round(x, 4) for x in ms['packed']]}, unpacked "
        f"{[round(x, 4) for x in ms['unpacked']]}")
    return res


def packed_frame(model, grid, cfgs, device, turns=2):
    """Phase 14 (e): phase 4's first test-config frame (240×320, pose 0)
    through the render's fp8 packed table (packed anew, fresh_frame)
    against the same frame unpacked (packed_max_entries 0: hash_encode_fwd),
    in turns: the share of equal labels, |Δ| of rgb and depth (reported:
    fp8 rows quantize the packed levels' features), host and device ms.
    The unpacked frame is held to its plain version as phase 4 holds the
    packed ones (labels >= 0.99, mean |Δrgb| <= 1e-3, mean |Δdepth| <=
    1e-2; the plain path launches nothing)."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import device_ms
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer
    rays = get_rays(look_at(POSES[0]), INTRINSICS, 240, 320, device=device)
    sides = {"packed": NeRFTrainer(model, cfgs["test"], image_hw=(240, 320),
                                   device=device),
             "unpacked": NeRFTrainer(model, replace(cfgs["test"],
                                                    packed_max_entries=0),
                                     image_hw=(240, 320), device=device)}
    frames = {k: (lambda tr=tr: fresh_frame(tr, None, rays, grid))
              for k, tr in sides.items()}
    outs, host, dev, launches = {}, {k: [] for k in sides}, \
        {k: [] for k in sides}, {}
    for t in range(turns):
        for name in (("packed", "unpacked") if t % 2 == 0
                     else ("unpacked", "packed")):
            kernels.reset_launches()
            outs[name], ms = timed(frames[name])
            launches[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
            host[name].append(ms)
            dev[name].append(device_ms(frames[name], iters=3, warmup=1))
    assert launches["packed"].get("hash_encode_fwd", 0) == 0 and \
        launches["packed"]["pack_table"] == 1, launches
    assert launches["unpacked"].get("hash_encode_packed_fwd", 0) == 0 and \
        launches["unpacked"].get("pack_table", 0) == 0 and \
        launches["unpacked"]["hash_encode_fwd"] > 0, launches
    agree = _frame_agreement(outs["packed"], outs["unpacked"])
    kernels.reset_launches()
    with kernels.plain_versions():
        ref, plain_ms = timed(frames["unpacked"])
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    plain = _frame_agreement(outs["unpacked"], ref)
    log(f"  (e) the unpacked frame against its plain version: "
        + " ".join(f"{k} {v:.3e}" for k, v in plain.items())
        + f"; plain {plain_ms:.2f} ms")
    assert plain["labels"] >= 0.99, plain
    assert plain["rgb_mean"] <= 1e-3 and plain["depth_mean"] <= 1e-2, plain
    res = dict(agreement=agree, host_ms=host, device_ms=dev,
               launches=launches, unpacked_against_plain=plain,
               unpacked_plain_ms=plain_ms)
    log(f"  (e) test frame, fp8 packed against unpacked: "
        + " ".join(f"{k} {v:.3e}" for k, v in agree.items())
        + f"; device ms packed {[round(x, 4) for x in dev['packed']]} "
        f"unpacked {[round(x, 4) for x in dev['unpacked']]}; host ms packed "
        f"{[round(x, 2) for x in host['packed']]} unpacked "
        f"{[round(x, 2) for x in host['unpacked']]}")
    return res


PACKED_JOINT_TURNS = 3  # rounds of (packed, unpacked, unpacked, packed)


def packed_joint(targets, device, seed):
    """Phase 14 (g): phase 8's joint step of 4 new frames (a test-config
    render, 4 NeRF steps, the seg step) at the card's packing defaults
    against the same step with both budgets 0 (packed_max_entries and
    train_packed_max_entries), two JointTrainers from the same seeds,
    after an untimed first step each, in turns (packed, unpacked,
    unpacked, packed; PACKED_JOINT_TURNS rounds): host ms a step
    (synchronised) and launches a step. Every loss finite; the packed
    side packs and never launches hash_encode_fwd, the unpacked side the
    reverse. TF32 on, as phase 8."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3,
                                                        SemanticNeRF)
    from ucsa_neural_rendering_tpu_torch.train import JointTrainer
    scene = {"img": torch.stack([f["nerf_rgb"] for f in targets]),
             "depth": torch.stack([f["nerf_depth"] for f in targets]),
             "pose": torch.stack([torch.as_tensor(
                 look_at(POSES[i % len(POSES)]), device=device)
                 for i in range(len(targets))]),
             "intrinsics": torch.tensor(INTRINSICS, device=device).expand(
                 len(targets), 4),
             "one_m_to_scene_uom": torch.ones(len(targets), device=device)}
    idx = [i % len(targets) for i in range(JOINT_NEW)]
    batch = {k: v[idx] for k, v in scene.items()}
    cfgs = {"packed": train_config(),
            "unpacked": replace(train_config(), packed_max_entries=0,
                                train_packed_max_entries=0)}
    sides = {}
    for name, cfg in cfgs.items():
        nerf = SemanticNeRF(**TRAIN_MODEL, device=device,
                            generator=torch.Generator().manual_seed(seed))
        seg = DeepLabV3(num_classes=SEG_CLASSES, device=device,
                        generator=torch.Generator().manual_seed(seed + 1))
        jt = JointTrainer(JOINT_EXP, image_hw=SEG_HW,
                          num_classes=SEG_CLASSES, render_cfg=cfg,
                          n_rays=N_RAYS, nerf_model=nerf, seg_model=seg,
                          device=device)
        jt.init()
        sides[name] = dict(jt=jt, grid=jt.init_occupancy(), ms=[],
                           gen=torch.Generator(device).manual_seed(seed + 2))
    step = lambda side: side["jt"].joint_step(None, batch, None, side["gen"],
                                              side["grid"])
    launches = {}
    torch.backends.cudnn.benchmark = False
    with tf32(True):
        for name, side in sides.items():
            kernels.reset_launches()
            logs = step(side)
            launches[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
            assert all(math.isfinite(float(v)) for v in logs.values()), logs
        for _ in range(PACKED_JOINT_TURNS):
            for name in ("packed", "unpacked", "unpacked", "packed"):
                logs, ms = timed(lambda: step(sides[name]))
                assert all(math.isfinite(float(v))
                           for v in logs.values()), logs
                sides[name]["ms"].append(ms)
    kernels.reset_launches()
    assert launches["packed"]["pack_table"] > 0 and \
        "hash_encode_fwd" not in launches["packed"], launches
    assert launches["unpacked"]["hash_encode_fwd"] > 0 and \
        "pack_table" not in launches["unpacked"], launches
    med = {name: statistics.median(side["ms"]) for name, side in sides.items()}
    ms = {name: [round(t, 2) for t in side["ms"]]
          for name, side in sides.items()}
    log(f"  (g) joint step ({JOINT_NEW} new) in turns: packed median "
        f"{med['packed']:.2f} ms of {ms['packed']}, unpacked median "
        f"{med['unpacked']:.2f} ms of {ms['unpacked']}; launches a step "
        f"packed {launches['packed']}, unpacked {launches['unpacked']}")
    res = dict(ms={name: side["ms"] for name, side in sides.items()},
               median_ms=med, launches_per_step=launches)
    del sides
    torch.cuda.empty_cache()
    return res


def packed_phase(model, grid, cfgs, targets, train, device, seed):
    """Phase 14, the packed paths (K8 and K9's hybrids) at the shipped
    geometry: (a) and (b), pack_table and hash_encode_packed_fwd against
    their plain versions, ran with phase 3 (check_packed_tables,
    check_packed_encode); (c) packed_step; (d) the "fine" and "face"
    hybrids' 16 steps each ran in phase 5 (k9_run: in turns with the plain
    path, step-1 losses within 2e-3, level sums within 5e-4, the loss
    falls), summarised here; (e) packed_frame; (f) the face bench
    (bench/face_encode.py: hash_encode_face_fwd against the packed face at
    the step's 98,304 / 32,768 points, 8 × 4 and 16 × 2, in turns); (g)
    packed_joint."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench import face_encode
    intr = torch.tensor(INTRINSICS, device=device)
    out0 = targets[0]
    batch = {"pose": torch.as_tensor(look_at(POSES[0]), device=device),
             "intrinsics": intr, "image": out0["nerf_rgb"],
             "label": out0["nerf_semantics"], "depth": out0["nerf_depth"],
             "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
    res = {"step": packed_step(batch, device, seed)}
    res["hybrids"] = {
        mode: {k: train["stochastic_fwd"][mode][k] for k in (
            "launches_per_step", "step1_loss_rel_err",
            "step1_loss_rel_err_placed", "step1_level_sum_err_placed",
            "median_ms_per_step", "plain_median_ms_per_step",
            "last8_mean_loss")}
        for mode in ("fine", "face")}
    for mode, h in res["hybrids"].items():
        log(f"  (d) stochastic_fwd={mode!r}: launches per step "
            f"{h['launches_per_step']}, step 1 losses "
            f"{h['step1_loss_rel_err']:.3e} of plain, level sums "
            f"{h['step1_level_sum_err_placed']:.3e} (same positions), median "
            f"{h['median_ms_per_step']:.2f} ms a step")
    res["frame"] = packed_frame(model, grid, cfgs, device)
    log(profiles_line())
    res["face_bench"] = face_encode.measure(device, turns=2, seed=seed)
    for r in res["face_bench"]["shapes"]:
        log(f"  (f) face bench {r['levels']} x {r['features']}, "
            f"{r['points']} points ({r['n_packed']} levels packed): "
            f"hash_encode_face_fwd {r['unpacked']['ms']} ms, packed face "
            f"{r['packed']['ms']} ms: packed / unpacked "
            f"{r['packed_over_unpacked']:.3f}")
    res["joint"] = packed_joint(targets, device, seed)
    kernels.reset_launches()
    return res


# ------------------------------------------------- the native loader
NATIVE_FRAMES = 20  # phase 10's room: 20 frames of 240×320, JPEG colour
NATIVE_RGB_TOL = 1 / 255 + 1e-6


def native_phase(seed, out_dir, probe):
    """Phase 16: the port's native loader (data/native_loader.py), built
    here from its own source by the route the probe allows (phase 1:
    a = the system's headers, b = the carried headers and the runtime
    libraries by file name). Where it builds: a synthetic room of
    NATIVE_FRAMES frames of 240×320 (phase 10's, JPEG colour) read through
    it and through data/image_io.py at 240×320 and at 120×160: labels and
    depth bit-equal, RGB within NATIVE_RGB_TOL (the decoders' and the
    resizes' rounding), its max |Δ| recorded; host ms a frame (RGB, label
    and depth) each way, and load_rgb_batch's ms a frame on its thread
    pool. Where the probe found a route (a or b) it must build and load:
    the phase fails with status()'s reason otherwise. Where the probe found
    none (c): the probe and status()'s reason are printed and recorded
    (ROADMAP), and the datasets read through image_io."""
    import tempfile

    import numpy as np

    from ucsa_neural_rendering_tpu_torch.data import native_loader
    from ucsa_neural_rendering_tpu_torch.data.image_io import (
        read_png, read_rgb, resize_area, resize_nearest)
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_scene_dir
    native_loader.reset()
    t0 = time.perf_counter()
    st = native_loader.status()
    res = {"status": st, "build_s": time.perf_counter() - t0,
           "probe_route": probe.get("route")}
    log(f"  native loader: {st} (probe route {probe.get('route')}, "
        f"{res['build_s']:.2f} s)")
    assert st["available"] or probe.get("route") not in ("a", "b"), (
        f"the probe found route {probe.get('route')} but the native loader "
        f"did not build or load: {st['reason']}")
    if not st["available"]:
        log(f"  the native loader is unavailable on this machine: "
            f"{st['reason']}; the datasets read through data/image_io.py")
        return res
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        write_synthetic_scene_dir(tmp, "scene0000_00",
                                  n_frames=NATIVE_FRAMES, H=SEG_HW[0],
                                  W=SEG_HW[1])
        scene = os.path.join(tmp, "scene0000_00")
        names = sorted(os.listdir(os.path.join(scene, "color_scaled")),
                       key=lambda f: int(f.split(".")[0]))
        files = [(os.path.join(scene, "color_scaled", n),
                  os.path.join(scene, "label_40_scaled",
                               n.split(".")[0] + ".png"),
                  os.path.join(scene, "depth", n.split(".")[0] + ".png"))
                 for n in names]

        def native(rgb, label, depth, h, w):
            return (native_loader.load_rgb(rgb, w, h),
                    native_loader.load_label(label, w, h),
                    native_loader.load_depth(depth, w, h))

        def image_io(rgb, label, depth, h, w):
            return (resize_area(read_rgb(rgb).astype(np.float32) / 255.0,
                                (h, w)),
                    resize_nearest(read_png(label), (h, w)).astype(np.int32),
                    resize_nearest(read_png(depth), (h, w)).astype(
                        np.float32) / 1000.0)

        for h, w in (SEG_HW, (SEG_HW[0] // 2, SEG_HW[1] // 2)):
            rec = {"rgb_max_abs": 0.0}
            ms = {"native": [], "image_io": []}
            for f in files:
                out = {}
                for name, fn in (("native", native), ("image_io", image_io)):
                    t0 = time.perf_counter()
                    out[name] = fn(*f, h, w)
                    ms[name].append(1e3 * (time.perf_counter() - t0))
                a, b = out["native"], out["image_io"]
                assert all(x is not None for x in a), f
                rec["rgb_max_abs"] = max(rec["rgb_max_abs"],
                                         float(np.abs(a[0] - b[0]).max()))
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[2], b[2])
            assert rec["rgb_max_abs"] <= NATIVE_RGB_TOL, rec
            t0 = time.perf_counter()
            batch, status = native_loader.load_rgb_batch(
                [f[0] for f in files], w, h)
            batch_ms = 1e3 * (time.perf_counter() - t0) / len(files)
            assert (status == 0).all(), status
            for i, f in enumerate(files):
                np.testing.assert_array_equal(
                    batch[i], native_loader.load_rgb(f[0], w, h))
            rec.update(ms_per_frame={k: statistics.median(v)
                                     for k, v in ms.items()},
                       batch_rgb_ms_per_frame=batch_ms)
            res[f"{h}x{w}"] = rec
            log(f"  native loader at {h}x{w}: max |Δrgb| "
                f"{rec['rgb_max_abs']:.3g} (≤ {NATIVE_RGB_TOL:.6f}), labels "
                f"and depth bit-equal; host ms a frame native "
                f"{rec['ms_per_frame']['native']:.3f}, image_io "
                f"{rec['ms_per_frame']['image_io']:.3f}; load_rgb_batch "
                f"{batch_ms:.3f} ms a frame on {os.cpu_count()} cores")
    return res


# ------------------------------------------------- data parallelism
DP_TURNS = 3  # steps a side in (a), in turns
DP_LOSS_REL = 2e-3  # two ranks' step-1 losses against one rank's
DP_LABELS = 0.99  # two ranks' labels equal to one rank's, at least
DP_CONF = 0.999  # confusion matrices' pixels in common, at least
# phase 15 (b)'s pretrain runs: (precision, optimizer); dp_two_ranks
DP_PRETRAIN_RUNS = (("f32", "Adam"), ("f64", "SGD"))
# the f64 run's global gradient of each step against one rank's,
# ||Δ|| / ||g||, at most DP_GRAD_REL; a reduce that broadcast rank 0's
# gradient must read above DP_GRAD_WRONG. Measured on the H100 (PERF.md
# §6): two ranks 1.6e-7 / 1.4e-3 to 1.7e-7 / 1.8e-3 at steps 1 / 2, a
# repeat of the one-rank run 1.6e-7 / 2.3e-3 to 1.9e-7 / 3.2e-3 (before the
# CLIs set cuDNN's deterministic mode), rank 0's own gradient × 2 1.18 to
# 1.52
DP_GRAD_REL = 2e-2
DP_GRAD_WRONG = 0.5
DP_25K_FRAMES = 5  # a scene: 8 train frames (2 steps of 4), 2 val, 2 test
# a NeRF step's kernels on the card's defaults (a joint step's too)
TRAIN_KERNELS_DP = JOINT_KERNELS


def rel1(a, b):
    """|a − b| / |b| of two numbers (b the reference)."""
    return abs(a - b) / max(abs(b), 1e-30)


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _bit_equal(m, *others, what):
    """Every tensor of state M bit-equal to the other runs' (the same
    init, steps and draws: every sum of the path in a fixed order).
    Returns the count."""
    for o in others:
        _assert_same_bits(m, o, what)
    return {"tensors_bit_equal": len(m), "runs": 1 + len(others)}


def _dp_targets(targets, device):
    intr = torch.tensor(INTRINSICS, device=device)
    return [{"pose": torch.as_tensor(look_at(POSES[i % len(POSES)]),
                                     device=device),
             "intrinsics": intr, "image": out["nerf_rgb"],
             "label": out["nerf_semantics"], "depth": out["nerf_depth"],
             "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
            for i, out in enumerate(targets)]


def _dp_joint_batch(targets, device):
    """The joint step's new batch: JOINT_NEW of phase 4's test renders."""
    frames = [targets[i % len(targets)] for i in range(JOINT_NEW)]
    return {"img": torch.stack([f["nerf_rgb"] for f in frames]),
            "depth": torch.stack([f["nerf_depth"] for f in frames]),
            "pose": torch.stack([torch.as_tensor(look_at(
                POSES[i % len(POSES)]), device=device)
                for i in range(JOINT_NEW)]),
            "intrinsics": torch.tensor(INTRINSICS, device=device).expand(
                JOINT_NEW, 4),
            "one_m_to_scene_uom": torch.ones(JOINT_NEW, device=device)}


def _dp_joint_trainer(device, seed, mesh):
    from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3,
                                                        SemanticNeRF)
    from ucsa_neural_rendering_tpu_torch.train import JointTrainer
    nerf = SemanticNeRF(**TRAIN_MODEL, device=device,
                        generator=torch.Generator().manual_seed(seed))
    seg = DeepLabV3(num_classes=SEG_CLASSES, device=device,
                    generator=torch.Generator().manual_seed(seed + 1))
    jt = JointTrainer(JOINT_EXP, image_hw=SEG_HW, num_classes=SEG_CLASSES,
                      render_cfg=train_config(), n_rays=N_RAYS,
                      nerf_model=nerf, seg_model=seg, device=device,
                      mesh=mesh)
    jt.init()
    return jt


def dp_one_rank(targets, device, seed):
    """Phase 15 (a): one rank over NCCL (a one-rank process group on this
    card) against mesh=None, at full width: the shipped NeRF's train_step
    (4096 rays), SegTrainer.train_step on R101 at batch 4, a joint_step of
    4 new frames. Four sides from one init: M (mesh=get_mesh()), A, B and
    C (mesh=None), DP_TURNS steps each in turns (M, A, B, C, then
    rotated).
    Step 1's losses of the NeRF and the seg step bit-equal, M's to A's; the
    joint step's losses and, after the steps, every parameter of M, A, B
    and C bit-equal (_bit_equal); host ms a step of each side: M − A
    is the collectives' cost (all-reduces of the gradients, the losses,
    the depth count and the confusion matrix at one rank). TF32 on,
    cudnn.benchmark off and cudnn.deterministic on (its weight-gradient
    algorithms would otherwise differ between two runs too)."""
    import tempfile

    import torch.distributed as dist

    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import (DeepLabV3,
                                                        SemanticNeRF)
    from ucsa_neural_rendering_tpu_torch.parallel import get_mesh, shutdown
    from ucsa_neural_rendering_tpu_torch.train import (NeRFTrainer,
                                                       SegTrainer)
    res = {}
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1, device_id=device)
    mesh = get_mesh(device)
    assert (mesh.size, mesh.backend) == (1, "nccl"), mesh

    def turns(make, step, name):
        """make(mesh) → a side; step(side, i) → its losses (a dict of
        floats); DP_TURNS steps a side in turns. Returns (sides, losses,
        host ms) by side name, launches counted over M's steps."""
        sides = {"M": make(mesh), "A": make(None), "B": make(None),
                 "C": make(None)}
        losses = {k: [] for k in sides}
        ms = {k: [] for k in sides}
        launches = dict.fromkeys(kernels.LAUNCHES, 0)
        order = list(sides)
        for i in range(DP_TURNS):
            for k in order[i % 4:] + order[:i % 4]:
                kernels.reset_launches()
                out, t = timed(lambda: step(sides[k], i))
                if k == "M":
                    for n, v in kernels.LAUNCHES.items():
                        launches[n] += v
                losses[k].append(out)
                ms[k].append(t)
        res[name] = {"ms": ms, "ms_median": {
            k: statistics.median(v) for k, v in ms.items()},
            "losses": losses, "launches": launches}
        log(f"  {name}: host ms a step, median of {DP_TURNS}: mesh "
            f"{res[name]['ms_median']['M']:.2f}, none " + " / ".join(
                f"{res[name]['ms_median'][k]:.2f}" for k in "ABC"))
        return sides, losses

    try:
        with tf32(True):
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.deterministic = True
            # the NeRF step
            batches = _dp_targets(targets, device)

            def make_nerf(m):
                model = SemanticNeRF(**TRAIN_MODEL, device=device,
                                     generator=torch.Generator()
                                     .manual_seed(seed))
                tr = NeRFTrainer(model, train_config(), n_rays=N_RAYS,
                                 image_hw=SEG_HW, device=device, mesh=m)
                tr.init()
                return {"tr": tr, "grid": tr.init_occupancy(),
                        "gen": torch.Generator(device).manual_seed(seed + 1)}

            def nerf_step(side, i):
                parts = side["tr"].train_step(batches[i % len(batches)],
                                              side["gen"], side["grid"])
                return {k: v.item() for k, v in parts.items()}

            sides, losses = turns(make_nerf, nerf_step, "nerf")
            assert all(losses[k][0] == losses["M"][0] for k in "ABC"), losses
            res["nerf"]["params"] = _bit_equal(
                *(_state(sides[k]["tr"].model) for k in "MABC"),
                what="nerf")
            missing = [k for k in TRAIN_KERNELS_DP
                       if res["nerf"]["launches"][k] <= 0]
            assert not missing, f"not launched on the mesh step: {missing}"
            del sides

            # the seg step
            images, labels = seg_batch(seed + 2, SEG_BATCH, device)

            def make_seg(m):
                tr = SegTrainer(DeepLabV3(
                    num_classes=SEG_CLASSES, device=device,
                    generator=torch.Generator().manual_seed(seed + 3)),
                    {"name": "Adam", "lr": 1e-4}, device=device, mesh=m)
                tr.init()
                return tr

            def seg_step(tr, i):
                loss, conf = tr.train_step(
                    images, labels, 1e-4,
                    torch.Generator(device).manual_seed(seed + 4 + i))
                return {"loss": loss.item(), "conf": conf.cpu()}

            sides, losses = turns(make_seg, seg_step, "seg")
            assert all(losses[k][0]["loss"] == losses["M"][0]["loss"]
                       for k in "ABC"), losses
            assert torch.equal(losses["M"][0]["conf"], losses["A"][0]["conf"])
            res["seg"]["losses"] = {k: [x["loss"] for x in v]
                                    for k, v in losses.items()}
            res["seg"]["params"] = _bit_equal(
                *(_state(sides[k].model) for k in "MABC"), what="seg")
            del sides

            # the joint step of JOINT_NEW new frames
            new = _dp_joint_batch(targets, device)

            def make_joint(m):
                jt = _dp_joint_trainer(device, seed + 5, m)
                return {"jt": jt, "grid": jt.init_occupancy(),
                        "gen": torch.Generator(device).manual_seed(seed + 6)}

            def joint_step(side, i):
                logs = side["jt"].joint_step(None, new, None, side["gen"],
                                             side["grid"])
                return {k: v.item() for k, v in logs.items()}

            sides, losses = turns(make_joint, joint_step, "joint")
            assert all(losses[o][0] == losses["M"][0] for o in "ABC"), \
                {o: losses[o][0] for o in "MABC"}
            res["joint"]["params"] = {
                n: _bit_equal(*(_state(getattr(sides[k]["jt"], n).model)
                               for k in "MABC"), what=f"joint {n}")
                for n in ("nerf", "seg")}
            del sides
    finally:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False
        shutdown()
    return res


def _dp_joint_rank(mesh, targets_cpu, seed, device=None):
    """Phase 15 (b)'s joint step on one rank of two (run_ranks), or with
    mesh None on `device` as the one-rank reference: the same trainer and
    batch, the pseudo-labels, the logs, the parameters and the launches
    back to the parent. TF32 off (dp_two_ranks' docstring)."""
    from ucsa_neural_rendering_tpu_torch import kernels
    device = mesh.device if mesh is not None else device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    targets = [{k: v.to(device) for k, v in t.items()} for t in targets_cpu]
    jt = _dp_joint_trainer(device, seed, mesh)
    new = _dp_joint_batch(targets, device)
    grid = jt.init_occupancy()
    gen = torch.Generator(device).manual_seed(seed + 1)
    pseudo = {}
    infer = jt.seg.infer

    def recorded(images, update_bn=False):
        out = infer(images, update_bn)
        pseudo.setdefault("labels", out[0].cpu())
        return out
    jt.seg.infer = recorded
    kernels.reset_launches()
    logs, ms = timed(lambda: jt.joint_step(None, new, None, gen, grid))
    launches = dict(kernels.LAUNCHES)
    return {"logs": {k: v.item() for k, v in logs.items()}, "ms": ms,
            "pseudo": pseudo["labels"], "launches": launches,
            "nerf": {k: v.cpu() for k, v in _state(jt.nerf.model).items()},
            "seg": {k: v.cpu() for k, v in _state(jt.seg.model).items()}}


def _grad_diff(a, b):
    """Two gradient lists (a against the reference b, a tensor a
    parameter, None where it got no gradient): "l2", the relative L2
    distance of the whole vectors, ||a − b|| / ||b||; "max_rel", the
    largest over the tensors of max |a − b| / max |b|, and "at", that
    tensor's index and its share of ||b||."""
    assert [x is None for x in a] == [y is None for y in b]
    d2 = n2 = 0.0
    worst, at = 0.0, None
    for i, (x, y) in enumerate(zip(a, b)):
        if y is None:
            continue
        x, y = x.double(), y.double()
        d2 += float(((x - y) ** 2).sum())
        n2 += float((y ** 2).sum())
        m = float(y.abs().max())
        r = float((x - y).abs().max()) / m if m > 0 else 0.0
        if r > worst:
            worst, at = r, (i, float(y.norm()))
    return {"l2": (d2 / n2) ** 0.5, "max_rel": worst,
            "at": None if at is None else [at[0], at[1] / n2 ** 0.5]}


def _logit_diff(a, b):
    """Eval logits [N, C, H, W] of two runs (b the reference): max |a − b|,
    and of the pixels whose argmax differs, the largest top-2 margin in b
    (how close to a tie those pixels were), and the share of b's pixels
    whose margin is below max |a − b|."""
    d = float((a - b).abs().max())
    top2 = b.topk(2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    differ = a.argmax(dim=1) != b.argmax(dim=1)
    return {"max_abs": d, "differ": float(differ.float().mean()),
            "differ_margin_max": float(margin[differ].max())
            if differ.any() else 0.0,
            "below_max_abs": float((margin < d).float().mean())}


def _conf_common(a, b):
    """The share of b's pixels that a's confusion matrix has in common."""
    return float(torch.minimum(a, b).sum() / b.sum().clamp_min(1))


def dp_pretrain_worker(out_dir, argv, f64=False):
    """One rank of phase 15 (b)'s pretrain, as `python3 chip_smoke.py
    --dp-worker OUT [--f64] -- ARGV` under torch.distributed.run (or alone,
    for the one-rank reference): the port's pretrain CLI's main(ARGV),
    with each step's global loss, every confusion matrix the meters take
    (global) and the eval labels and logits recorded, and on rank 0 each
    step's global gradient (the .grad the step left) and, under the
    launcher, its own gradient of step 1 before the all-reduce; then this
    rank's parameters, its launches and its step ms saved to
    OUT/rank<RANK>.pt. Under the launcher the worker initialises the
    process group over gloo itself (two ranks share the one card, which
    NCCL refuses), and the CLI's mesh takes that group. The CLI turns TF32
    on; the run trains with it off (dp_two_ranks' docstring). --f64: the
    CLI's DeepLabV3 is made .double() and computes in f64 (its logits
    leave in f32, as always)."""
    import torch.distributed as dist

    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.metrics import SemanticsMeter
    from ucsa_neural_rendering_tpu_torch.parallel import Mesh, shutdown
    from ucsa_neural_rendering_tpu_torch.scripts import pretrain
    from ucsa_neural_rendering_tpu_torch.train import SegTrainer, pretrain_loop
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo")
    rank0 = os.environ.get("RANK", "0") == "0"
    if f64:
        make = pretrain_loop.DeepLabV3
        pretrain_loop.DeepLabV3 = lambda **kw: make(
            **{**kw, "compute_dtype": torch.float64}).double()
    rec = {"losses": [], "confs": [], "preds": [], "logits": [],
           "step_ms": [], "grads": []}
    train = pretrain_loop.train

    def f32_train(*a, **kw):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return train(*a, **kw)
    pretrain_loop.train = f32_train
    real = (SegTrainer.train_step, SegTrainer.eval_step,
            SemanticsMeter.update_confmat, Mesh.all_reduce_grads)

    def grads(params):
        return [p.grad.detach().cpu() if p.grad is not None else None
                for p in params]

    def train_step(self, *a, **kw):
        (loss, conf), ms = timed(lambda: real[0](self, *a, **kw))
        rec["losses"].append(loss.item())
        rec["step_ms"].append(ms)
        if rank0:
            rec["grads"].append(grads(self.model.parameters()))
        return loss, conf

    def all_reduce_grads(self, params):
        params = list(params)
        if self.rank == 0 and "grads_rank0_own" not in rec:
            rec["grads_rank0_own"] = grads(params)
        return real[3](self, params)

    def eval_step(self, images):
        preds, logits = real[1](self, images)
        rec["preds"].append(preds.cpu())
        rec["logits"].append(logits.cpu())
        return preds, logits

    def update_confmat(self, conf):
        rec["confs"].append(conf.cpu())
        return real[2](self, conf)

    SegTrainer.train_step, SegTrainer.eval_step = train_step, eval_step
    SemanticsMeter.update_confmat = update_confmat
    Mesh.all_reduce_grads = all_reduce_grads
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer, best = pretrain.main(argv)
    rec["wall_s"] = time.perf_counter() - t0
    rec["best"] = best
    rec["state"] = {k: v.cpu() for k, v in _state(trainer.model).items()}
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["mesh"] = None if trainer.mesh is None else [
        trainer.mesh.rank, trainer.mesh.size, trainer.mesh.backend,
        str(trainer.mesh.device)]
    torch.save(rec, os.path.join(out_dir,
                                 f"rank{os.environ.get('RANK', '0')}.pt"))
    shutdown()
    return 0


def _dp_pretrain_runs(tmp, exp, exp_path, seed, prec):
    """Phase 15 (b)'s pretrain runs at precision `prec` (f32 or f64, the
    worker's --f64): the CLI alone twice (one, one_b) and under the
    launcher over two ranks (two); each run's records (dp_pretrain_worker)
    by name, a list of its ranks'."""
    runs = {}
    for name, launcher in (("one", []), ("one_b", []), ("two", [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"])):
        run_dir = os.path.join(tmp, f"{prec}_{name}")
        os.makedirs(run_dir)
        exp["general"]["name"] = f"dp_{prec}_{name}"
        with open(exp_path, "w") as f:
            f.write("\n".join(_yaml(exp)) + "\n")
        cmd = [sys.executable, *launcher, os.path.join(REPO, "chip_smoke.py"),
               "--dp-worker", run_dir, *(["--f64"] if prec == "f64" else []),
               "--", "--exp", exp_path, "--seed", str(seed)]
        t0 = time.perf_counter()
        # one CPU thread a process in every run, as the launcher gives its
        # ranks: the host augmentation's float reductions (colour jitter)
        # round by the thread count, and a fresh R101 turns an input's
        # last bit into per cents of its gradient
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=REPO,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, (prec, name, proc.stdout[-3000:],
                                      proc.stderr[-6000:])
        ranks = sorted(f for f in os.listdir(run_dir) if f.endswith(".pt"))
        runs[name] = [torch.load(os.path.join(run_dir, f), weights_only=False)
                      for f in ranks]
        runs[name][0]["launcher_wall_s"] = wall
        shutil.rmtree(run_dir)
    return runs


def _dp_pretrain_compare(runs, split, label):
    """The two-rank run and the repeated one-rank run (one_b), each against
    the one-rank run: every step's loss (relative), global gradient
    (_grad_diff), confusion matrix (_conf_common), and the eval labels
    and logits (_logit_diff); rank 0's own step-1 gradient × the world
    size against one rank's; the ranks bit-equal. Logged; the caller
    holds them."""
    one, one_b, (r0, r1) = runs["one"][0], runs["one_b"][0], runs["two"]
    assert one["mesh"] is None and r0["mesh"][1:3] == [2, "gloo"] and \
        r1["mesh"][:3] == [1, 2, "gloo"], (one["mesh"], r0["mesh"])
    assert len(r0["losses"]) == len(one["losses"]) == -(-split["train"] // 4)
    assert r0["losses"] == r1["losses"]
    _assert_same_bits(r0["state"], r1["state"], "pretrain ranks")
    size = r0["mesh"][1]
    # the eval passes (val, then test): each batch is rank 0's block then
    # rank 1's, padded to 4 rows by wraparound as one rank pads
    two = {"losses": r0["losses"], "grads": r0["grads"],
           "confs": r0["confs"],
           "preds": [torch.cat(p) for p in zip(r0["preds"], r1["preds"])],
           "logits": [torch.cat(p) for p in zip(r0["logits"],
                                                r1["logits"])]}
    ref_preds, ref_logits = torch.cat(one["preds"]), torch.cat(one["logits"])
    assert split["val"]

    def against_one(run):
        preds, logits = torch.cat(run["preds"]), torch.cat(run["logits"])
        assert preds.shape == ref_preds.shape
        assert len(run["confs"]) == len(one["confs"])
        return {"loss_rel": [rel1(a, b) for a, b in zip(
                    run["losses"], one["losses"], strict=True)],
                "grad": [_grad_diff(a, b) for a, b in zip(
                    run["grads"], one["grads"], strict=True)],
                "conf_common": [_conf_common(a, b) for a, b in zip(
                    run["confs"], one["confs"])],
                "labels": float((preds == ref_preds).float().mean()),
                "logits": _logit_diff(logits, ref_logits)}
    cmp = {"two": against_one(two), "one_b": against_one(one_b)}
    own = _grad_diff([None if g is None else size * g
                      for g in r0["grads_rank0_own"]], one["grads"][0])
    for k, c in cmp.items():
        # "at" is None where the two gradients are bit-equal
        grads = ", ".join(
            f"{g['l2']:.3g} (bit-equal)" if g["at"] is None else
            f"{g['l2']:.3g} (worst tensor {g['at'][0]}: {g['max_rel']:.3g})"
            for g in c["grad"])
        log(f"  pretrain ({label}), {k} against one rank: loss rel "
            f"{[f'{x:.3g}' for x in c['loss_rel']]}; gradient ||Δ||/||g|| "
            f"{grads}; confusion in common "
            f"{[round(x, 5) for x in c['conf_common']]}; eval labels "
            f"{c['labels']:.5f}; eval logits {c['logits']}")
    log(f"  pretrain ({label}): rank 0's own step-1 gradient × {size} "
        f"against one rank's: ||Δ||/||g|| {own['l2']:.3g}; step ms two "
        f"ranks {r0['step_ms']}, one rank {one['step_ms']} / "
        f"{one_b['step_ms']}; ranks bit-equal")
    return {"against_one": cmp, "rank0_own": own,
            "losses": {"two": r0["losses"], "one": one["losses"],
                       "one_b": one_b["losses"]},
            "step_ms": {"two": [r0["step_ms"], r1["step_ms"]],
                        "one": one["step_ms"], "one_b": one_b["step_ms"]},
            "wall_s": {k: v[0]["launcher_wall_s"] for k, v in runs.items()}}


def dp_two_ranks(targets, device, seed, out_dir):
    """Phase 15 (b): two ranks on this one card over gloo (NCCL refuses
    two ranks on one GPU), against one rank, at full width:
      (1) the port's pretrain CLI under `python -m torch.distributed.run
          --standalone --nproc-per-node 2` (the worker initialises gloo),
          1 epoch of 2 steps at batch 4 (2 images a rank; split loading)
          on a 25k tree of 2 × DP_25K_FRAMES synthetic frames at 240×320,
          then its val and test passes; the same CLI alone twice as the
          reference and its repeat (dp_pretrain_worker records all);
          once in f32 with the experiment's Adam, as users run it, and
          once with the R101 in f64 and SGD (the experiment's lr,
          momentum 0.9) (DP_PRETRAIN_RUNS);
      (2) a joint_step of JOINT_NEW new frames over two spawned ranks
          (parallel.dryrun.run_ranks, gloo), against the same step on one
          rank (mesh=None) in this process.
    Why f64: a fresh R101 turns rounding in its forward into per cents
    of its gradient, and an update multiplies a gradient's difference
    ~10^4× by the next step. In f32 (on the H100, PERF.md §6) the two
    ranks' step-1 gradient differs from one rank's by ~3 % (||Δ|| /
    ||g||) while the step-1 loss agrees to ~2e-7; in f64 they read
    ~1.6e-7 and ~2e-3. So only f64 can show the gradients after an
    update equal one rank's. (Before the CLIs set cuDNN's deterministic
    mode, a repeat of the one-rank run differed from it too, by ~3e-6 at
    step 1 and 3–7 % at step 2 in f32; the repeat's distance is logged,
    "bit-equal" where its gradients are.) Every run takes one CPU thread, as the
    launcher gives its ranks (_dp_pretrain_runs). Why SGD there: Adam's first update is
    lr · g / (|g| + eps), lr · sign(g) wherever |g| ≫ eps, so the
    parameters after it would hide a gradient's size; SGD's update is
    linear in it.
    Checks: (1) in both runs the step-1 loss within DP_LOSS_REL of one
    rank's and step 1's confusion matrix in common with one rank's on
    ≥ DP_CONF of its pixels; in the f64 run also every step's loss within
    DP_LOSS_REL, every step's global gradient within DP_GRAD_REL of one
    rank's (_grad_diff), rank 0's own gradient of step 1 times the world
    size, what a reduce that only broadcast rank 0's would give, above
    DP_GRAD_WRONG (the check can see such a fault), every confusion
    matrix ≥ DP_CONF and the val and test labels after the steps equal on
    ≥ DP_LABELS of the pixels; the f32 run's later numbers are recorded
    beside its repeat's; (2) step-1 losses within DP_LOSS_REL and the
    pseudo-labels (the BN trick, at batch 2 a rank) equal on ≥ DP_LABELS
    of the pixels; in all the two ranks' parameters bit-equal and every
    rank launched the NeRF step's kernels in (2). TF32 off throughout: at
    TF32 a fresh R101's labels move on ~0.3 % of the pixels with the
    batch's layout alone (PERF.md: TF32 against f32 0.997)."""
    import tempfile

    from ucsa_neural_rendering_tpu_torch.config import load_yaml
    from ucsa_neural_rendering_tpu_torch.data import load_split
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_25k_dir
    from ucsa_neural_rendering_tpu_torch.parallel.dryrun import run_ranks
    from ucsa_neural_rendering_tpu_torch.scripts import create_split
    res = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        env = {"results": os.path.join(tmp, "results"),
               "scannet_frames_25k": os.path.join(tmp, "frames_25k")}
        with open(os.path.join(tmp, "env.yml"), "w") as f:
            f.write("\n".join(_yaml(env)) + "\n")
        f25k = env["scannet_frames_25k"]
        write_synthetic_25k_dir(f25k, n_scenes=2,
                                n_frames_per_scene=DP_25K_FRAMES,
                                H=SEG_HW[0], W=SEG_HW[1], frame_gain=0.1,
                                pixel_noise=0.02)
        exp = load_yaml(os.path.join(REPO, PRETRAIN_EXP))
        exp["data_module"]["root"] = f25k
        exp["trainer"].update(max_epochs=1, save_last=False)
        exp["visualizer"] = {"store": False}
        exp_path = os.path.join(tmp, "pretrain.yml")
        with open(exp_path, "w") as f:
            f.write("\n".join(_yaml(exp)) + "\n")
        os.environ["ENV_WORKSTATION_NAME"] = os.path.join(tmp, "env")
        split_path, _ = create_split.main(["--config", exp_path, "--seed",
                                           str(seed)])
        split = {k: len(v) for k, v in load_split(split_path).items()}
        res["split"] = split
        for prec, optimizer in DP_PRETRAIN_RUNS:
            exp["optimizer"]["name"] = optimizer
            runs = _dp_pretrain_runs(tmp, exp, exp_path, seed, prec)
            res[f"pretrain_{prec}"] = cmp = _dp_pretrain_compare(
                runs, split, f"{prec}, {optimizer}")
            c = cmp["against_one"]["two"]
            assert c["loss_rel"][0] <= DP_LOSS_REL, c["loss_rel"]
            assert c["conf_common"][0] >= DP_CONF, c["conf_common"]
            if prec == "f64":
                assert max(c["loss_rel"]) <= DP_LOSS_REL, c["loss_rel"]
                assert max(g["l2"] for g in c["grad"]) <= DP_GRAD_REL, \
                    c["grad"]
                assert cmp["rank0_own"]["l2"] > DP_GRAD_WRONG, \
                    cmp["rank0_own"]
                assert min(c["conf_common"]) >= DP_CONF, c["conf_common"]
                assert c["labels"] >= DP_LABELS, c["labels"]

        # (2) the joint step
        targets_cpu = [{k: t[k].cpu() for k in ("nerf_rgb", "nerf_depth",
                                               "nerf_semantics")}
                       for t in targets]
        ranks = run_ranks(_dp_joint_rank, 2, os.path.join(tmp, "joint"),
                          targets_cpu, seed + 1, device="cuda",
                          backend="gloo", timeout=600)
        with tf32(False):
            ref = _dp_joint_rank(None, targets_cpu, seed + 1, device)
    for part in ("nerf", "seg"):
        _assert_same_bits(ranks[0][part], ranks[1][part], f"joint {part}")
    assert ranks[0]["logs"] == ranks[1]["logs"]
    for k, v in ref["logs"].items():
        assert rel1(ranks[0]["logs"][k], v) <= DP_LOSS_REL, \
            (k, ranks[0]["logs"], ref["logs"])
    agree = float((ranks[0]["pseudo"] == ref["pseudo"]).float().mean())
    assert agree >= DP_LABELS, agree
    for r in ranks:
        missing = [k for k in TRAIN_KERNELS_DP if r["launches"][k] <= 0]
        assert not missing, f"a rank launched no {missing}"
    res["joint"] = {"logs_two": ranks[0]["logs"], "logs_one": ref["logs"],
                    "ms_two": [r["ms"] for r in ranks], "ms_one": ref["ms"],
                    "pseudo_agreement": agree,
                    "launches_rank0": ranks[0]["launches"]}
    log(f"  joint step over 2 gloo ranks on one card: {ranks[0]['logs']} "
        f"against one rank's {ref['logs']}; host ms {res['joint']['ms_two']}"
        f" (one rank {ref['ms']:.1f}); pseudo-labels {agree:.5f}; ranks "
        f"bit-equal")
    return res


GATE_SEED = 123
GATE_ARMS = ("accel16x2", "prop32e8x4")  # the incumbent, the shipped arm
# the gate's chain cut in depth: 2 scenes of 5 frames (4 train + 1 val:
# 4 frames leave a scene no val frame), 4 fit epochs (16 steps, so each
# stage refreshes its grid once), 1 joint epoch, 10 pretrain epochs (after
# 3 the tiny seg net's val mIoU is still 0 on every scene; after 10 it is
# in some draws too, since the pretrain on the card does not repeat bit
# for bit, and then (c)'s val mIoU compares zeros: its NeRF losses do not)
GATE_CUT = ["--scenes", "2", "--frames", "5", "--pretrain-epochs", "10",
            "--nerf-epochs", "4", "--joint-epochs", "1"]
GATE_TIMEOUT = 600  # seconds for the whole chain
# what a stage of either arm launches: the occupancy arms' path
GATE_KERNELS = STAGE_KERNELS
# fit_synthetic's steps run the dense program (no grid)
FIT_KERNELS = DENSE_KERNELS
# fit_synthetic on the kernels against the plain versions: each loss part
# over the first FIT_HELD_STEPS steps within FIT_LOSS_REL of the plain
# run's step-1 value of that part (on an H100 80GB HBM3 at 700 W the two
# paths stay within 4e-4 of it to step 10 and part from step ~20); then
# PSNR dB and semantic accuracy. A 120-step fit at lr 1e-2 ends wherever
# its last steps' bounce leaves it (there: 33.79 dB on the kernels, 31.64
# plain, in every run), so the PSNR limit holds only a fit that failed
FIT_HELD_STEPS, FIT_LOSS_REL = 10, 2e-3
FIT_PSNR_DB, FIT_ACC = 6.0, 0.02
# after stage 0 of prop32e8x4, kernels against the plain versions from one
# pretrain checkpoint: the NeRF's first fit epoch's mean losses
# (GATE_NERF_LOSSES) within FIT_LOSS_REL of plain's; its test mIoU after
# the fit and after the joint epoch (GATE_NERF_KEYS; at this cut a fit of
# 16 steps renders the test frame nearly one class, 0.06-0.17 either way,
# so the losses are what a NeRF kernel's fault moves) and the seg net's
# new-scene val mIoU, each within GATE_PLAIN_MIOU
GATE_NERF_LOSSES = ("train/loss_nerf_rgb", "train/loss_nerf_semantics",
                    "train/loss_depth")
GATE_PLAIN_MIOU = 0.05
GATE_NERF_KEYS = ("test_pre/nerf_mean_IoU", "test/nerf_mean_IoU")
GATE_METRIC_KEYS = ("test/nerf_mean_IoU", "test_pre/nerf_mean_IoU",
                    "val_pre/seg_mean_IoU_scene0000_00",
                    "val_e1/seg_mean_IoU_scene0000_00")
GATE_STAGE_LAUNCHES = "kernel launches: "


def _epoch_metrics(path, key):
    """Each record's value of `key` in a metrics.jsonl, in order (the fit
    epochs' for a NeRF training loss)."""
    with open(path) as f:
        return [rec[key] for rec in map(json.loads, f) if key in rec]


def gate_phase():
    """Phase 17: the synthetic continual-learning quality gate through the
    port's CLIs.
    (a) scripts/fit_synthetic at its defaults (120 steps, 32 × 40, the
        dense program), counts zeroed before and read after (every kernel
        of FIT_KERNELS launched), then the same run inside
        plain_versions() (no launch): every loss part of the first
        FIT_HELD_STEPS steps within FIT_LOSS_REL of the plain run's step-1
        value of that part, PSNR within FIT_PSNR_DB and semantic accuracy
        within FIT_ACC of the plain run's.
    (b) scripts/quality_gate at reduced depth (GATE_CUT, seed GATE_SEED,
        the arms GATE_ARMS, --seg-tiny and the full-size NeRF at 120 × 160)
        in its own process, which runs every phase as a subprocess, one at
        a time, and ends with the report table and gate_decision: every
        subprocess
        exits 0 (phases.jsonl); each stage's final_val.json, metrics.jsonl
        with GATE_METRIC_KEYS and each arm's report are written; every
        entry of each 2 × 2 val-mIoU matrix is finite and in [0, 1]; the
        decision lists cl_replay_on_proposal_enc8x4 over 1 seed with no
        throughput; each stage process's launch counts are printed and
        every kernel of GATE_KERNELS launched in each arm's stages.
    (c) Stage 0 of prop32e8x4 again in this process inside plain_versions()
        (TF32 on, as the CLI sets it), on a copy of (b)'s data and pretrain
        checkpoint: the NeRF's first fit epoch's losses (GATE_NERF_LOSSES)
        within FIT_LOSS_REL of (b)'s, its test mIoU (GATE_NERF_KEYS) and
        the new scene's val mIoU each within GATE_PLAIN_MIOU. Returns the
        records (chip_smoke.json's "gate") and the launches of (a) and (b)
        by kernel."""
    import tempfile
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.scripts import (exp_synthetic_cl,
                                                         fit_synthetic,
                                                         gate_report_table,
                                                         quality_gate)
    res = {}
    # (a)
    kernels.reset_launches()
    fit = fit_synthetic.main(["--device", "cuda"])
    fit_launches = dict(kernels.LAUNCHES)
    missing = [k for k in FIT_KERNELS if fit_launches[k] <= 0]
    assert not missing, f"kernels not launched by fit_synthetic: {missing}"
    kernels.reset_launches()
    with kernels.plain_versions():
        fit_plain = fit_synthetic.main(["--device", "cuda"])
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    # each step's worst loss part, as a share of that part's plain step 1
    step_rel = [max(abs(fit["losses"][k][i] - v[i]) / abs(v[0])
                    for k, v in fit_plain["losses"].items())
                for i in range(len(fit_plain["losses"]["loss_nerf_total"]))]
    held = max(step_rel[:FIT_HELD_STEPS])
    d_psnr = fit["psnr"] - fit_plain["psnr"]
    d_acc = fit["acc"] - fit_plain["acc"]
    log(f"  (a) fit_synthetic: the first {FIT_HELD_STEPS} steps' losses "
        f"within {held:.3e} of plain's step 1 (limit {FIT_LOSS_REL}); each "
        f"step's: {[float(f'{r:.2e}') for r in step_rel]}")
    log(f"  (a) fit_synthetic: PSNR {fit['psnr']:.3f} dB, semantic acc "
        f"{fit['acc']:.4f}, {fit['seconds']:.2f} s on the kernels; plain "
        f"{fit_plain['psnr']:.3f} dB, {fit_plain['acc']:.4f}, "
        f"{fit_plain['seconds']:.2f} s (limits {FIT_PSNR_DB} dB, {FIT_ACC})")
    res["fit"] = {"kernels": fit, "plain": fit_plain, "step_rel": step_rel,
                  "held_rel": held, "launches": {
                      k: v for k, v in fit_launches.items() if v}}
    assert held <= FIT_LOSS_REL, step_rel[:FIT_HELD_STEPS]
    assert math.isfinite(fit["psnr"]) and abs(d_psnr) <= FIT_PSNR_DB, d_psnr
    assert abs(d_acc) <= FIT_ACC, d_acc

    # (b)
    prop = "cl_replay_on_proposal_enc8x4"
    arms = {"accel16x2": "cl_replay_on", "prop32e8x4": prop}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        base = os.path.join(tmp, "gate")
        argv = ["--base", base, "--seeds", str(GATE_SEED), "--arms",
                ",".join(GATE_ARMS), *GATE_CUT]
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m",
             "ucsa_neural_rendering_tpu_torch.scripts.quality_gate", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=GATE_TIMEOUT)
        res["chain_s"] = time.time() - t0
        log("\n".join("  " + line for line in run.stdout.splitlines()))
        assert run.returncode == 0, (run.returncode, run.stderr[-4000:])
        with open(os.path.join(base, "phases.jsonl")) as f:
            phases = [json.loads(line) for line in f]
        res["phases"] = phases
        assert phases and all(p["rc"] == 0 for p in phases), phases
        seed_root = os.path.join(base, f"seed{GATE_SEED}")
        results = os.path.join(seed_root, "experiments")
        scenes = exp_synthetic_cl.scene_names(2)
        launches = {k: 0 for k in kernels.LAUNCHES}
        res["launches_per_process"] = {}
        res["reports"] = {}
        for tag, arm in arms.items():
            with open(os.path.join(results, f"report_{arm}.json")) as f:
                rep = json.load(f)
            res["reports"][tag] = rep
            mat = rep["val_mIoU"]
            assert sorted(mat) == ["stage_0", "stage_1"], mat
            for row in mat.values():
                assert sorted(row) == scenes, row
                assert all(math.isfinite(v) and 0 <= v <= 1
                           for v in row.values()), row
            arm_launches = {k: 0 for k in kernels.LAUNCHES}
            for i in range(2):
                stage = os.path.join(results, arm, f"stage_{i}")
                assert os.path.exists(os.path.join(stage, "final_val.json"))
                with open(os.path.join(stage, "metrics.jsonl")) as f:
                    text = f.read()
                absent = [k for k in GATE_METRIC_KEYS
                          if f'"{k}": ' not in text]
                assert not absent, (stage, absent)
                tag_i = f"{tag}_seed{GATE_SEED}_s{i}"
                with open(os.path.join(base, "logs", f"{tag_i}.log")) as f:
                    line = [ln for ln in f if GATE_STAGE_LAUNCHES in ln][-1]
                counts = json.loads(line.split(GATE_STAGE_LAUNCHES, 1)[1])
                res["launches_per_process"][tag_i] = counts
                log(f"  (b) {tag_i} launches: {counts}")
                for k, v in counts.items():
                    arm_launches[k] += v
                    launches[k] += v
            missing = [k for k in GATE_KERNELS if arm_launches[k] <= 0]
            assert not missing, f"{tag}: kernels not launched: {missing}"
            log(f"  (b) {tag}: val mIoU {mat}, new {rep['new_scene_mIoU_mean']}"
                f", old {rep['old_scene_final_mIoU_mean']}")
        with open(os.path.join(base, "decision.json")) as f:
            decision = json.load(f)
        with open(os.path.join(base, "table.json")) as f:
            res["table"] = json.load(f)
        res["decision"] = decision
        log(f"  (b) decision: {json.dumps(decision)}")
        cand = {c["arm"]: c for c in decision["candidates"]}
        assert cand[prop]["seeds"] == 1 and \
            cand[prop]["rays_per_sec"] is None, cand
        assert isinstance(cand[prop]["passes_gate"], bool)
        assert decision["promote"] is None
        log(f"  (b) the chain took {res['chain_s']:.1f} s: " + ", ".join(
            f"{p['tag']} {p['seconds']:.1f}" for p in phases))

        # (c)
        plain_base = os.path.join(tmp, "plain")
        plain_root = os.path.join(plain_base, f"seed{GATE_SEED}")
        for sub in ("scans", "frames25k", os.path.join("experiments",
                                                       "pretrain25k")):
            shutil.copytree(os.path.join(seed_root, sub),
                            os.path.join(plain_root, sub))
        qa = quality_gate.parse_args(["--base", plain_base, *GATE_CUT])
        a = exp_synthetic_cl.parse_args(
            [*quality_gate.common_for(qa, GATE_SEED),
             *quality_gate.ARMS["prop32e8x4"]])
        with tf32(True), kernels.plain_versions():
            t0 = time.time()
            final = exp_synthetic_cl.phase_stage(a, 0)
            res["plain_stage_s"] = time.time() - t0
        assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
        got = res["reports"]["prop32e8x4"]["val_mIoU"]["stage_0"][scenes[0]]
        ref = final[scenes[0]]["mIoU"]
        res["stage0_new_miou"] = {"kernels": got, "plain": ref}
        metrics = [os.path.join(root, "experiments", arms["prop32e8x4"],
                                "stage_0", "metrics.jsonl")
                   for root in (seed_root, plain_root)]
        res["stage0_nerf_losses"] = {
            key: dict(zip(("kernels", "plain"),
                          (_epoch_metrics(m, key) for m in metrics)))
            for key in GATE_NERF_LOSSES}
        res["stage0_nerf_miou"] = {
            key: dict(zip(("kernels", "plain"),
                          (gate_report_table.last_metric(m, key)
                           for m in metrics)))
            for key in GATE_NERF_KEYS}
        loss_rel = max(abs(v["kernels"][0] - v["plain"][0]) / abs(v["plain"][0])
                       for v in res["stage0_nerf_losses"].values())
        res["stage0_nerf_loss_rel"] = loss_rel
        log(f"  (c) prop32e8x4 stage 0, the NeRF's fit epochs' mean losses, "
            f"kernels / plain: " + "; ".join(
                f"{key} {v['kernels']} / {v['plain']}"
                for key, v in res["stage0_nerf_losses"].items()))
        log(f"  (c) the first fit epoch's losses within {loss_rel:.3e} "
            f"(limit {FIT_LOSS_REL}); the NeRF's test mIoU: " + ", ".join(
                f"{key} kernels {v['kernels']:.4f}, plain {v['plain']:.4f}"
                for key, v in res["stage0_nerf_miou"].items()))
        log(f"  (c) prop32e8x4 stage 0, new-scene val mIoU: kernels {got:.4f}"
            f", plain {ref:.4f} (limit {GATE_PLAIN_MIOU} on each); the plain "
            f"stage took {res['plain_stage_s']:.1f} s")
        assert loss_rel <= FIT_LOSS_REL, res["stage0_nerf_losses"]
        for key, v in res["stage0_nerf_miou"].items():
            assert abs(v["kernels"] - v["plain"]) <= GATE_PLAIN_MIOU, (key, v)
        assert abs(got - ref) <= GATE_PLAIN_MIOU, (got, ref)
    for k, v in fit_launches.items():
        launches[k] += v
    return res, launches


# ------------------------------------------------------------ phase 18
# every process of phase 18 runs under torch.use_deterministic_algorithms
# (True), which needs cuBLAS's workspace fixed before CUDA starts, at one
# thread count (the host augmentation's float reductions round by it)
REPEAT_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8", "OMP_NUM_THREADS": "4"}
REPEAT_STEPS = 32  # (b): steps of each K9 mode's fit, refreshes every 16
# (b): the K9 training encoders, each on the card's packing defaults
REPEAT_MODES = {"False": False, "True": True, "face": "face", "fine": "fine"}
REPEAT_ARM = "prop32e8x4"  # (c): the shipped arm's stage
REPEAT_TIMEOUT = 600  # seconds for any one process of the phase
# (d): hash_encode_bwd at the shipped step's 4096 × 32 points (8 × 4) and
# the dense step's 4096 × 512 (16 × 2)
REPEAT_BWD = (("step", 8, 4, 32), ("dense step", 16, 2, 512))


def repeat_worker(what, out, argv):
    """One process of phase 18, under torch.use_deterministic_algorithms(
    True) (the parent sets REPEAT_ENV): "cli" runs the exp_synthetic_cl
    CLI's main(argv); "steps" runs repeat_steps and writes its records to
    `out`."""
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if what == "cli":
        from ucsa_neural_rendering_tpu_torch.scripts import exp_synthetic_cl
        exp_synthetic_cl.main(argv)
        return 0
    res = repeat_steps(torch.device("cuda", 0), int(argv[0]))
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


def _ray_points(n_rays, samples, seed, device):
    """x01 of `samples` points along each of n_rays rays inside the box,
    as a step's samples lie."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n_rays, 3), generator=g) - 0.5
    d = torch.randn((n_rays, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(0.0, 0.5, samples)
    x = (o[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)
    return ((x + 1.0) / 2.0).to(device).contiguous()


def repeat_steps(device, seed):
    """Phase 18 (b), (c)'s joint step and (d), in one process under
    torch.use_deterministic_algorithms(True), TF32 and cuDNN's
    deterministic algorithms set as the CLIs set them; every run twice
    from one seed, held bit-equal:
    (b) a fresh shipped NeRF fit of REPEAT_STEPS steps (update_occupancy
        every 16th) in each K9 mode of REPEAT_MODES on the card's packing
        defaults, on a synthetic room of 3 frames of 240×320: every
        parameter, gradient and Adam moment, the grid and every loss;
    (c) one joint step of JOINT_NEW new frames (the shipped NeRF and a
        full-width R101, phase 15's trainer): both models' states, both
        optimizers' states and the logs;
    (d) hash_encode_bwd in each mode at REPEAT_BWD's shapes: the gradient.
    Returns the records; any op without a deterministic form raises."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        make_synthetic_scene
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.train import NeRFTrainer
    from ucsa_neural_rendering_tpu_torch.utils.device import \
        set_deterministic
    torch.backends.cudnn.allow_tf32 = True
    set_deterministic()
    res = {"fit": {}}
    frames, intr = make_synthetic_scene(n_frames=3, H=SEG_HW[0], W=SEG_HW[1])
    intr = torch.as_tensor(intr, device=device)
    batches = [{"pose": torch.as_tensor(f["pose"], device=device),
                "intrinsics": intr,
                "image": torch.as_tensor(f["image"], device=device),
                "label": torch.as_tensor(f["label"], device=device).long(),
                "depth": torch.as_tensor(f["depth"], device=device),
                "one_m_to_scene_uom": torch.tensor(1.0, device=device)}
               for f in frames]

    # (b)
    def fit(mode):
        model = SemanticNeRF(**TRAIN_MODEL, device=device,
                             generator=torch.Generator().manual_seed(seed),
                             stochastic_fwd=mode)
        tr = NeRFTrainer(model, train_config(), n_rays=N_RAYS,
                         image_hw=SEG_HW, device=device)
        tr.init()
        gen = torch.Generator(device).manual_seed(seed + 1)
        grid = tr.init_occupancy()
        losses = []
        for i in range(REPEAT_STEPS):
            parts = tr.train_step(batches[i % len(batches)], gen, grid)
            losses.append({k: v.item() for k, v in parts.items()})
            if (i + 1) % tr.occ_cfg.update_every == 0:
                grid = tr.update_occupancy(grid, gen)
        return {"states": _step_states(tr), "grid": grid, "losses": losses}

    for label, mode in REPEAT_MODES.items():
        kernels.reset_launches()
        t0 = time.time()
        a = fit(mode)
        b = fit(mode)
        _assert_same_bits(a, b, f"fit {label}")
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert launched.get("hash_encode_bwd", 0) == 4 * REPEAT_STEPS, \
            launched
        res["fit"][label] = {"seconds": time.time() - t0,
                             "losses_first_last": [a["losses"][0],
                                                   a["losses"][-1]],
                             "launches_two_fits": launched}
        log(f"  (b) fit {label}: {REPEAT_STEPS} steps twice, every "
            f"parameter, gradient, Adam moment, the grid and every loss "
            f"bit-equal; {res['fit'][label]['seconds']:.1f} s; launches "
            f"{launched}")
        del a, b

    # (c) the joint step
    new = {"img": torch.stack([batches[i % 3]["image"]
                               for i in range(JOINT_NEW)]),
           "depth": torch.stack([batches[i % 3]["depth"]
                                 for i in range(JOINT_NEW)]),
           "pose": torch.stack([batches[i % 3]["pose"]
                                for i in range(JOINT_NEW)]),
           "intrinsics": intr.expand(JOINT_NEW, 4),
           "one_m_to_scene_uom": torch.ones(JOINT_NEW, device=device)}

    def joint():
        jt = _dp_joint_trainer(device, seed + 2, None)
        logs = jt.joint_step(None, new, None,
                             torch.Generator(device).manual_seed(seed + 3),
                             jt.init_occupancy())
        return {"logs": {k: v.item() for k, v in logs.items()},
                **{n: {"model": getattr(jt, n).model.state_dict(),
                       "optimizer": getattr(jt, n).optimizer.state_dict()}
                   for n in ("nerf", "seg")}}

    t0 = time.time()
    a = joint()
    b = joint()
    _assert_same_bits(a, b, "joint step")
    res["joint_step"] = {"seconds": time.time() - t0, "logs": a["logs"]}
    log(f"  (c) a joint step twice: both models, both optimizers and the "
        f"logs bit-equal ({a['logs']}); {res['joint_step']['seconds']:.1f} s")
    del a, b

    # (d)
    res["bwd"] = []
    for where, levels, features, samples in REPEAT_BWD:
        spec = he.make_spec(levels, features, 19, 16,
                            he.ngp_per_level_scale(4.0, levels))
        x01 = _ray_points(4096, samples, seed + 4, device)
        g = torch.randn((x01.shape[0], spec.out_dim),
                        generator=torch.Generator().manual_seed(seed + 5)
                        ).to(device).to(torch.bfloat16)
        for stochastic in (True, False, "face"):
            a = he.hash_encode_bwd(x01, g, spec, stochastic)
            b = he.hash_encode_bwd(x01, g, spec, stochastic)
            _assert_same_bits(a, b, f"hash_encode_bwd {where} {stochastic}")
            res["bwd"].append({"where": where, "points": x01.shape[0],
                               "mode": str(stochastic), "bit_equal": True})
            del a, b
        log(f"  (d) hash_encode_bwd at the {where}'s {x01.shape[0]} points "
            f"({levels} x {features}), exact, stochastic and face: twice, "
            f"the same bits")
    return res


def _repeat_proc(what, out, argv, log_path):
    """A phase 18 process (repeat_worker) started in the background, its
    output to log_path."""
    f = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--repeat-worker", what,
         out, "--", *argv], cwd=REPO, env=dict(os.environ, **REPEAT_ENV),
        stdout=f, stderr=subprocess.STDOUT, text=True), f


def _repeat_wait(procs):
    """Wait for phase 18's processes; each must exit 0 (its log's tail in
    the failure otherwise)."""
    for (p, f), path in procs:
        rc = p.wait(timeout=REPEAT_TIMEOUT)
        f.close()
        with open(path) as g:
            tail = g.read()[-4000:]
        assert rc == 0, (path, rc, tail)


def _same_outputs(a, b):
    """Every checkpoint tree (tree.pt) under directory a bit-equal to b's,
    every metrics.jsonl record equal but for its wall-clock time, every
    final_val.json equal. Returns the files compared."""
    from ucsa_neural_rendering_tpu_torch.train.checkpoints import TREE_FILE
    seen = []
    for root, _, files in os.walk(a):
        for name in files:
            pa = os.path.join(root, name)
            pb = os.path.join(b, os.path.relpath(pa, a))
            if name == TREE_FILE:
                _assert_same_bits(torch.load(pa, weights_only=True),
                                  torch.load(pb, weights_only=True), pa)
            elif name == "metrics.jsonl":
                with open(pa) as fa, open(pb) as fb:
                    ra = [json.loads(line) for line in fa]
                    rb = [json.loads(line) for line in fb]
                for r in ra + rb:
                    r.pop("time", None)
                assert ra == rb, pa
            elif name == "final_val.json":
                with open(pa) as fa, open(pb) as fb:
                    assert json.load(fa) == json.load(fb), pa
            else:
                continue
            seen.append(os.path.relpath(pa, a))
    return sorted(seen)


REPEAT_LOG = (
    f"phase 18: the training paths repeat bit for bit, each process under "
    f"torch.use_deterministic_algorithms(True): (a) the gate's pretrain "
    f"({' '.join(GATE_CUT)}, seed {GATE_SEED}) twice in two processes; (b) "
    f"a {REPEAT_STEPS}-step shipped NeRF fit in each K9 mode twice; (c) a "
    f"joint step twice and stage 0 of {REPEAT_ARM} twice in two processes; "
    f"(d) hash_encode_bwd twice in each mode")


def repeat_phase(seed):
    """Phase 18: the port's training repeats bit for bit on the card. Every
    process runs under torch.use_deterministic_algorithms(True) (an op
    without a deterministic form raises and fails the phase), at
    REPEAT_ENV's cuBLAS workspace and thread count.
    (a) The gate's pretrain CLI (exp_synthetic_cl --phase pretrain) at
        phase 17's cut, seed GATE_SEED, twice in two processes on one
        data phase's data: every tensor of its checkpoints and every
        logged record (losses, mIoU) bit-equal.
    (b) repeat_steps' NeRF fits in each K9 mode, (c) its joint step and a
        stage of REPEAT_ARM through the CLI (exp_synthetic_cl --phase
        stage, stage 0 from each (a) run's pretrain) twice in two
        processes: the stage's checkpoints (NeRF and seg), logged records
        and final val mIoU bit-equal, (d) hash_encode_bwd twice in each
        mode at REPEAT_BWD's shapes: repeat_steps' docstring.
    The pretrains run side by side, then the stages; repeat_steps beside
    them. Returns the records (chip_smoke.json's "repeat")."""
    import tempfile
    from ucsa_neural_rendering_tpu_torch.scripts import quality_gate
    res = {}
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repeat_") as tmp:
        steps_out = os.path.join(tmp, "steps.json")
        steps_log = os.path.join(tmp, "steps.log")
        steps = (_repeat_proc("steps", steps_out, [str(seed)], steps_log),
                 steps_log)
        bases = [os.path.join(tmp, f"run{i}") for i in (0, 1)]

        def cli(base, *phase):
            qa = quality_gate.parse_args(["--base", base, *GATE_CUT])
            return [*quality_gate.common_for(qa, GATE_SEED), *phase]

        roots = [os.path.join(base, f"seed{GATE_SEED}") for base in bases]
        t0 = time.time()
        data_log = os.path.join(tmp, "data.log")
        _repeat_wait([(_repeat_proc("cli", "-", cli(bases[0], "--phase",
                                                    "data"), data_log),
                       data_log)])
        for sub in ("scans", "frames25k"):
            shutil.copytree(os.path.join(roots[0], sub),
                            os.path.join(roots[1], sub))
        res["data_s"] = time.time() - t0

        def both(tag, *phase):
            t0 = time.time()
            logs = [os.path.join(tmp, f"{tag}{i}.log") for i in (0, 1)]
            _repeat_wait([(_repeat_proc("cli", "-", cli(base, *phase), path),
                           path) for base, path in zip(bases, logs)])
            return time.time() - t0

        # (a)
        res["pretrain_s"] = both("pretrain", "--phase", "pretrain")
        pre = [os.path.join(r, "experiments", "pretrain25k") for r in roots]
        res["pretrain_files"] = _same_outputs(*pre)
        assert any(f.endswith("tree.pt") for f in res["pretrain_files"]) \
            and "metrics.jsonl" in res["pretrain_files"], res
        log(f"  (a) the gate's pretrain ({' '.join(GATE_CUT)}, seed "
            f"{GATE_SEED}) twice in two processes: bit-equal "
            f"{res['pretrain_files']}; data {res['data_s']:.1f} s, the two "
            f"pretrains side by side {res['pretrain_s']:.1f} s")

        # (c) the stage
        res["stage_s"] = both("stage", "--phase", "stage", "--stage-idx",
                              "0", *quality_gate.ARMS[REPEAT_ARM])
        stage = [os.path.join(r, "experiments") for r in roots]
        res["stage_files"] = [f for f in _same_outputs(*stage)
                              if not f.startswith("pretrain25k")]
        assert sum(f.endswith("tree.pt") for f in res["stage_files"]) >= 2 \
            and any(f.endswith("final_val.json")
                    for f in res["stage_files"]), res
        log(f"  (c) stage 0 of {REPEAT_ARM} twice in two processes: "
            f"bit-equal {res['stage_files']}; the two side by side "
            f"{res['stage_s']:.1f} s")

        _repeat_wait([steps])
        with open(steps_out) as f:
            res.update(json.load(f))
        with open(steps_log) as f:
            log("\n".join(line.rstrip() for line in f
                          if line.startswith("  (")))
    res["phase_s"] = time.time() - t_phase
    log(f"  phase 18 took {res['phase_s']:.1f} s")
    return res


def profile_run(fn, out_dir, name, by_name=False):
    """Device time by kernel name over one call of fn (torch.profiler), the
    device's busy time against the call's wall time: the sum of the
    device-side events' durations (one stream, so they do not overlap), and
    the number of those events (kernels, copies and fills).
    User annotations on the device timeline (the optimizer's
    `Optimizer.step#...` range) span other events and the gaps between
    them: they are left out of the sum and reported apart. kernel_ms sums
    the device time of each of the port's kernels (mlp_bwd's dW reduction
    with it); by_name adds every device event name's summed ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ucsa_neural_rendering_tpu_torch import kernels
    symbols = {k: (f"{k}_kernel",) for k in kernels.LAUNCHES}
    symbols["mlp_bwd"] += ("mlp_dw_reduce_kernel",)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in device if e.is_user_annotation]
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in device
                         if not e.is_user_annotation)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=45)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(table)
    kernel_ms = {k: 1e-3 * sum(e.time_range.elapsed_us() for e in device
                               if any(sym in e.name for sym in syms))
                 for k, syms in symbols.items()}
    rec = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_ops=sum(not e.is_user_annotation for e in device),
        idle_share=1.0 - busy_ms / wall_ms,
        annotations={e.name: 1e-3 * e.time_range.elapsed_us() for e in spans},
        kernel_ms={k: v for k, v in kernel_ms.items() if v})
    if by_name:
        rec["by_name"] = {}
        for e in device:
            if not e.is_user_annotation:
                rec["by_name"][e.name] = rec["by_name"].get(e.name, 0.0) + \
                    1e-3 * e.time_range.elapsed_us()
    return table, rec


def main():
    if "--dp-worker" in sys.argv:
        # one rank of phase 15 (b)'s pretrain, started by the phase
        i = sys.argv.index("--dp-worker")
        j = sys.argv.index("--")
        return dp_pretrain_worker(sys.argv[i + 1], sys.argv[j + 1:],
                                  f64="--f64" in sys.argv[:j])
    if "--repeat-worker" in sys.argv:
        # one process of phase 18, started by the phase
        i = sys.argv.index("--repeat-worker")
        j = sys.argv.index("--")
        return repeat_worker(sys.argv[i + 1], sys.argv[i + 2],
                             sys.argv[j + 1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks (phase 3)")
    ap.add_argument("--repeat", action="store_true",
                    help="build the kernels, then run phase 18 alone")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--steps", type=int, default=32,
                    help="training steps per path (phase 5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and the profile table")
    args = ap.parse_args()

    # phase 1 (cuBLAS's workspace fixed before CUDA starts, for the phases
    # under deterministic_algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                          REPEAT_ENV["CUBLAS_WORKSPACE_CONFIG"])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ucsa_neural_rendering_tpu_torch import bench, kernels
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    assert smi.returncode == 0, smi.stderr
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    probe = subprocess.run([sys.executable, "-c", IMPORT_PROBE],
                           capture_output=True, text=True, timeout=300)
    log(f"third-party imports on this machine: {probe.stdout.strip()}")
    native = native_loader_probe()
    log(f"the native loader's headers and libraries: {native}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    secs = kernels.build()
    log(f"phase 2: built {len(kernels.SIGNATURES)} kernels in {secs:.1f} s")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    if args.repeat:
        log(REPEAT_LOG)
        repeat = repeat_phase(args.seed + 11)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_repeat.json"), "w") as f:
            json.dump({"card": card, "repeat": repeat}, f, indent=1)
        return 0

    # phase 3
    log("phase 3: kernels against their plain versions")
    model, grid = make_scene(device, args.seed)
    cfgs = render_configs()
    rec = check_kernels(model, grid, cfgs, device)
    check_train_kernels(model, grid, device, rec)
    check_fused_step_kernels(model, grid, device, rec)
    dense = dense_model(device, args.seed + 6)
    check_dense_kernels(model, dense, grid, device, rec)
    check_mlp_kernels(model, cfgs, device, rec, dense)
    log("phase 14 (a, b), with phase 3: the packed tables' kernels")
    check_packed_tables(model, dense, rec)
    del dense
    check_gather(device)
    log(profiles_line())
    if args.quick:
        log(first_versions_line())
        log(json.dumps({"kernels": list(rec.values())}))
        return 0

    # phase 4
    log(f"phase 4: {args.frames} frames of 240x320 per config")
    launches, results, trainers, outs = render_phase(model, grid, cfgs,
                                                     device, args.frames)
    missing = [k for k in RENDER_KERNELS if launches[k] <= 0]
    assert not missing, f"kernels not launched on the render path: {missing}"
    assert launches["hash_encode_fwd"] == 0, launches
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    rays0 = get_rays(look_at(POSES[0]), INTRINSICS, 240, 320, device=device)
    frame_fn = lambda: fresh_frame(trainers["test"], None, rays0, grid)
    table, busy = profile_run(frame_fn, args.out, "profile_test_frame.txt")
    log("\n".join(table.splitlines()[:16]))
    # the profiler's own host cost stretches the profiled frame; the same
    # frame (pose 0, test config) unprofiled took ms_per_frame[0]
    busy["idle_share_unprofiled"] = 1.0 - (
        busy["device_busy_ms"] / results["test"]["ms_per_frame"][0])
    with kernels.plain_versions(*MLP_KERNELS):
        _, busy_mlp = profile_run(frame_fn, args.out,
                                  "profile_test_frame_mlp_plain.txt")
    log(f"  profiled test frame: wall {busy['wall_ms']:.2f} ms, device busy "
        f"{busy['device_busy_ms']:.2f} ms, idle share "
        f"{busy['idle_share']:.3f} (against the unprofiled frame "
        f"{busy['idle_share_unprofiled']:.3f})")
    log(f"  device operations per test frame: {busy['device_ops']} (busy "
        f"{busy['device_busy_ms']:.3f} ms); with the MLP kernels plain "
        f"{busy_mlp['device_ops']} (busy {busy_mlp['device_busy_ms']:.3f} "
        f"ms)")
    log("  kernels' device ms in the profiled test frame: " + ", ".join(
        f"{k} {v:.4f}" for k, v in busy["kernel_ms"].items()))

    # phase 5
    log(f"phase 5: {args.steps} training steps per path, {N_RAYS} rays, "
        f"update_occupancy every 16")
    train_launches, train = train_phase(
        [outs["test", i] for i in range(args.frames)], device, args.steps,
        args.seed + 1, args.out)
    for name in rec:
        rec[name]["launches"] = launches[name] + train_launches[name]
        rec[name]["launches_render"] = launches[name]
        rec[name]["launches_train"] = train_launches[name]

    # phase 6
    log("phase 6: the row-gather benchmark")
    gather_phase(rec)
    log(profiles_line())

    # phase 7
    log(f"phase 7: DeepLabV3-ResNet101, {SEG_CLASSES} classes, batch "
        f"{SEG_BATCH} at {SEG_HW[0]}x{SEG_HW[1]} (TF32 and cudnn.benchmark "
        f"set in this phase only)")
    seg = seg_phase(device, args.seed, args.out)

    # phase 8
    log(f"phase 8: JointTrainer, the shipped Semantic-NeRF and "
        f"DeepLabV3-ResNet101 at {SEG_HW[0]}x{SEG_HW[1]}: {PSEUDO_FRAMES} "
        f"pseudo-labels, a {FIT_STEPS}-step fit epoch, {JOINT_STEPS} joint "
        f"steps of {JOINT_NEW} new frames, {CL_STEPS} of 1 new + 1 old + 2 "
        f"cl, a fused image step of {FUSED_IMAGES}, {PREDICT_FRAMES} "
        f"predicts; kernel and plain path in turns (TF32 on)")
    joint = joint_phase([outs["test", i] for i in range(args.frames)],
                        device, args.seed + 2, args.out)
    for name in rec:
        rec[name]["launches"] += joint["launches"][name]
        rec[name]["launches_joint_phase"] = joint["launches"][name]
        rec[name]["launches_joint"] = joint["launches_joint_step"][name]

    # phase 10
    log(f"phase 10: one stage through the CLI ({STAGE_EXP}, "
        f"--nerf_train_epoch {STAGE_EPOCHS[0]} --joint_train_epoch "
        f"{STAGE_EPOCHS[1]}, then a resumed call) on {STAGE_FRAMES} "
        f"synthetic frames of {SEG_HW[0]}x{SEG_HW[1]}")
    stage = stage_phase(device, args.seed + 3, args.out, card)
    for name in rec:
        rec[name]["launches"] += stage["launches"][name]
        rec[name]["launches_stage"] = stage["launches"][name]

    # phase 11
    log(f"phase 11: the multi-step protocol through the CL CLI ({CL_EXP}, "
        f"{len(CL_ROOMS)} stages of --nerf_train_epoch {CL_EPOCHS[0]} "
        f"--joint_train_epoch {CL_EPOCHS[1]}, then a resumed call) on "
        f"{CL_FRAMES} synthetic frames a room of {SEG_HW[0]}x{SEG_HW[1]} and "
        f"{CL_25K_SCENES * CL_25K_FRAMES} 25k frames of "
        f"{CL_25K_HW[0]}x{CL_25K_HW[1]}")
    with deterministic_algorithms():
        protocol = protocol_phase(device, args.seed + 4, args.out, card)
    for name in rec:
        rec[name]["launches_protocol"] = protocol["launches"][name]
        rec[name]["launches_protocol_resume"] = \
            protocol["resume_launches"][name]
        rec[name]["launches"] += protocol["launches"][name] \
            + protocol["resume_launches"][name]

    # phase 12
    log(f"phase 12: the pretrain, NeRF-only and finetune CLIs chained "
        f"({PRETRAIN_EXP} {PRETRAIN_EPOCHS[0]} epochs, then resumed to "
        f"{PRETRAIN_EPOCHS[1]}; {STAGE_EXP} --exp_name {NERF_ONLY} "
        f"--joint_train_epoch 0; {FINETUNE_EXP} {FINETUNE_EPOCHS[0]} epochs, "
        f"then {FINETUNE_EPOCHS[1]} with 25k replay) on "
        f"{LOOP_25K_SCENES * LOOP_25K_FRAMES} 25k frames of "
        f"{CL_25K_HW[0]}x{CL_25K_HW[1]} and a room of {LOOP_FRAMES} frames "
        f"of {SEG_HW[0]}x{SEG_HW[1]}")
    with deterministic_algorithms():
        loops = loops_phase(device, args.seed + 5, args.out, card)
    for name in rec:
        rec[name]["launches_nerf_only"] = \
            loops["nerf_only"]["launches"][name]
        rec[name]["launches"] += loops["nerf_only"]["launches"][name]

    # phase 13
    log(f"phase 13: the opt-in paths: the reference-parity stage through "
        f"the CLI ({STAGE_EXP} without its renderer block, nerf "
        f"use_occupancy false, {DENSE_LEVELS} x {DENSE_FEATURES} levels; "
        f"--nerf_train_epoch {DENSE_EPOCHS[0]} --joint_train_epoch "
        f"{DENSE_EPOCHS[1]}) on {DENSE_FRAMES} synthetic frames of "
        f"{SEG_HW[0]}x{SEG_HW[1]}; probe-placement renders; an exact "
        f"refresh; DeepLabV3-R101 bf16 against f32")
    dense = dense_phase(model, grid, cfgs, device, args.seed + 6, card,
                        args.out)
    for name in rec:
        rec[name]["launches_dense"] = dense["launches"][name]
        rec[name]["launches"] += dense["launches"][name]

    # phase 14
    log("phase 14: the packed paths at the shipped geometry: a packed step "
        "against the unpacked one, the hybrids' steps (phase 5), a test "
        "frame packed against unpacked, the face bench, a joint step "
        "packed against unpacked")
    packed = packed_phase(model, grid, cfgs,
                          [outs["test", i] for i in range(args.frames)],
                          train, device, args.seed + 7)

    # phase 15
    log(f"phase 15: data parallelism at full width (the shipped "
        f"Semantic-NeRF, DeepLabV3-R101): (a) one rank over NCCL against "
        f"mesh=None, {DP_TURNS} steps a side in turns: a NeRF step, a seg "
        f"step at batch {SEG_BATCH}, a joint step of {JOINT_NEW} new frames; "
        f"(b) two ranks on this card over gloo: the pretrain CLI under "
        f"torch.distributed.run (2 steps, 2 images a rank) and a joint step "
        f"of {JOINT_NEW} new frames, against one rank")
    targets = [outs["test", i] for i in range(args.frames)]
    dp = {"one_rank": dp_one_rank(targets, device, args.seed + 8)}
    dp["two_ranks"] = dp_two_ranks(targets, device, args.seed + 9, args.out)
    for name in rec:
        rec[name]["launches_dp"] = dp["one_rank"]["nerf"]["launches"][name] \
            + dp["one_rank"]["joint"]["launches"][name]
        rec[name]["launches"] += rec[name]["launches_dp"]
    log(f"  {card}: no multi-GPU run was made; this machine has one card, "
        f"so (b)'s two ranks share it over gloo")

    # phase 16
    log("phase 16: the native loader")
    native_res = native_phase(args.seed + 10, args.out, native)

    # phase 17
    log(f"phase 17: the synthetic continual-learning quality gate: "
        f"fit_synthetic on the kernels and plain; the gate through "
        f"quality_gate ({' '.join(GATE_CUT)}, seed {GATE_SEED}, "
        f"{' and '.join(GATE_ARMS)}); stage 0 of prop32e8x4 plain")
    t0 = time.time()
    gate, gate_launches = gate_phase()
    gate["phase_s"] = time.time() - t0
    log(f"  phase 17 took {gate['phase_s']:.1f} s")
    for name in rec:
        rec[name]["launches_gate"] = gate_launches[name]
        rec[name]["launches"] += gate_launches[name]

    # phase 18
    log(REPEAT_LOG)
    repeat = repeat_phase(args.seed + 11)
    log(profiles_line())
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "native_loader_probe": native,
                   "native_loader": native_res, "dp": dp,
                   "device_ms_profiles": bench.PROFILES,
                   "kernels": rec, "render": results,
                   "profiled_test_frame": busy,
                   "profiled_test_frame_mlp_plain": busy_mlp, "train": train,
                   "seg": seg, "joint": joint, "stage": stage,
                   "protocol": protocol, "loops": loops, "dense": dense,
                   "packed": packed, "gate": gate, "repeat": repeat}, f,
                  indent=1)

    # phase 9
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_nerf_only", "launches_dense", "launches_dp",
            "launches_gate", "floor_ms"]
    log(first_versions_line())
    log(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                for r in rec.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
