#!/usr/bin/env python3
"""On-card smoke run of samplenet_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a). It imports torch, numpy and the port, never
jax. It drives the port's five paths: the serving path (the SampleNet
eval forward with on-device hard matching, 1024 -> 32 points, bottleneck
128, B=1024), the classification-track train step (SampleNet, k=7,
sigma = t^2, against a frozen vanilla PointNet with 40 classes, B=1024),
the reconstruction track at the reference AE configuration (2048-point
clouds, B=50; the AE 3->64->128->128->256->128 + FC 256->256->6144 on the
EMD loss; the reconstruction sampler, m=64, k=16, against it), and the
progressive track at the reference's configurations (one ordered sampler
for every prefix size: 1024 points, B=32, sizes 8..1024 against the
frozen PointNet; 2048 points, B=50, sizes 16..2048 against the AE), and
the registration track at the reference's configuration (B=32 pairs of
1024-point clouds; PCRNet, no BN, bottleneck 1024; the sampler m=64,
bottleneck 128, k=8, both clouds sampled, against it frozen), and:

  1. prints the card (nvidia-smi name and power limit), nvcc and triton;
  2. builds the CUDA kernels from csrc/, prints the build time and what
     ptxas reports (registers, spills), and requires the SASS (cuobjdump)
     of point_mlp_max to multiply on the tensor cores (HMMA instructions);
     counts the 1-NN kernel's lane-instructions a (query, point) pair in
     the SASS of each of its 48 instantiations (its issue floor);
  3. holds each kernel against its plain PyTorch version on the card, at
     the serving path's shapes and at a ragged shape: nn_direction and FPS
     bit for bit, point_mlp_max within rtol = atol = 1e-4 (split TF32 on the
     tensor cores, sums in another order), with both against the plain
     version in float64 printed beside; then FPS, nn_direction and nn_snap
     on clouds with NaN and +-inf coordinates at the serving path's shape
     (FPS with random counts, count 1 and count k): idx equal, FPS's xyz
     and the snapped points bit for bit, distances equal with NaN at the
     same places; then nn_direction and nn_snap at every shape the five
     paths give them (NN_SHAPES), each under its launch plan and one other
     plan, bit for bit against the plain version;
  4. checks the eval forward of the kernel path against the plain path,
     then resets the launch counters, serves B=1024 clouds through
     BatchedSampler, and requires every kernel to have launched;
  5. starts `python -m samplenet_tpu_torch.serve` on port 0, posts 4
     concurrent requests (64 clouds) and requires answers bit-equal to a
     direct BatchedSampler call and kernel launches in the server; then
     (artifact) requires the f32 point_mlp_max, now through its
     torch.library op, to keep PR 16's SHA-1 digest, writes the serving
     artifact with `serve --export-artifact` on the card (B=256), requires
     its torch.export graph to hold samplenet::point_mlp_max, nn_direction
     and fps, loads it in the process (ArtifactSampler), requires its
     answer bit-equal to BatchedSampler with all three kernels launched,
     and serves it with `serve --artifact`: 4 concurrent POSTs bit-equal to
     BatchedSampler, all three kernels launched in the server; prints the
     export, load and first-call seconds;
  6. holds the train kernels against their plain versions: point_mlp_exact
     (exact-BN conv chain + max, forward and backward) and soft_projection
     (k-NN softmax mixture, forward and backward), at the train step's
     shapes and at ragged ones, soft_projection also at the progressive
     steps' (32 clouds of 1024 points, 1024 queries, k=7; 50 of 2048, 2048
     queries, k=16) and at 2 clouds of 16384 points (64 queries, k=16);
     both backward kernels bit for bit from run to run;
  7. runs one train step on the kernel path and on the plain path from
     the same state, holds both against the plain path in float64, then
     resets the launch counters, runs five augmented train steps and
     requires every train kernel, and nn_direction, to have launched;
  8. runs `python -m samplenet_tpu_torch.train.train_samplenet` for one
     epoch of 3 steps and again with --resume;
  9. (compare_recon) holds the EMD kernel against its plain version at
     B=50, 2048 x 2048 and at (n, m) = (96, 160), (128, 64), (2048, 64),
     with and without gradients, and at B=2, 320 x 320 with each xyz2_i
     where level * d2 straddles the kernel's skip threshold at a steep
     level, point_mlp_exact at the track's widths
     at B=50, N=2048, and through their own wrappers at the track's
     shapes point_mlp_max (B=50, 2048 points, its widths), fps (2048 ->
     64), nn_direction (64 -> 2048 and back) and soft_projection (k=16);
 10. (recon_train) runs one AE step and one sampler step on the kernel
     path, the plain path and the plain path in float64 from the same
     state, the SampleNet and FPS-baseline eval steps and evaluate_nre on
     the kernel and the plain path (per-cloud losses and NRE within rtol
     1e-4), then resets the launch counters, runs three AE steps, three
     sampler steps against the AE, one NRE evaluation and one FPS-baseline
     evaluation, and requires each of the track's kernels to have launched;
 11. (recon_cli) runs `python -m samplenet_tpu_torch.train.
     train_reconstruction` --phase ae (EMD loss), then --phase samplenet
     on its checkpoint with --fps-baseline, and with --progressive; then
     (ae_analysis) runs models/ae_analysis.py's nn_distances_per_cloud
     (B=50 clouds of 2048 points, 64 FPS points a cloud, the seeded AE)
     on the kernel path and under plain_on_cuda(): the 1-NN indices both
     ways equal, the per-cloud distances bit for bit, nn_direction
     launched; and reconstructions_from_sampled of the full clouds
     (point_mlp_max launched) within 1e-4;
 12. (compare, progressive) holds nn_snap bit for bit against its plain
     version at B=32, 1024 -> 1024 and at a ragged shape (N1 = 1000,
     N2 = 2500), and the ghost-BN chain point_mlp_train (forward and
     backward) against the plain version in float64 with bf16 off, at
     B=32, N=1024 in bf16 (block 4) and f32 (block 2) and at a ragged
     N = 1000; its backward bit for bit from run to run; in bf16 also
     against the plain bf16 version on the same block (the backward on
     the kernel forward's own state), with the kernel run with bf16 off
     as a control that must fail that check;
 13. (progressive) runs one progressive classification step (N=1024,
     B=32, sizes 8..1024, k=7, against the frozen PointNet) on each chain,
     exact BN and ghost BN (--fused-train, bf16), on the kernel path and
     the plain path from the same state, both held against the plain path
     in float64; then resets the launch counters, runs two steps per
     chain, the infer step (simplified, soft, hard, matched) and
     evaluate_prefixes, and requires every kernel of the track to have
     launched;
 14. (progressive-ae) runs one progressive AE step (B=50, 2048 points,
     sizes 16..2048, k=16) on the kernel path, the plain path and the
     plain path in float64, requires a nonzero gradient on every sampler
     conv layer, and evaluate_ae_prefix_nre on both paths;
 15. (progressive-cli) runs `python -m samplenet_tpu_torch.train.
     train_progressive --fused-train` for one epoch of 2 steps;
 16. (classifier) builds the T-net PointNetClassifier at its published
     widths (40 classes) from a seed on the CPU and moves it to the card:
     its forward at B=32, N=1024 within rtol 1e-4 (atol 1e-5 of scale) of
     the CPU's; one train step (dropout 0, augmentation off) on the card,
     on the CPU in f32 and in float64 from the same state: the loss within
     rtol 1e-4 of f64, each gradient norm-wise within 1e-2 of f64 and at
     most twice the CPU f32 step's error (or 1e-5), gradients that f64
     reads as zero round-off; a timed train step with dropout and
     augmentation; then `python -m samplenet_tpu_torch.train.
     train_classifier --device cuda --use-tnets --bn-schedule` for one
     epoch of 3 steps (ckpt and ckpt_last with use_tnets true) and
     train_samplenet --classifier-ckpt on it for one epoch of 2 steps;
 17. (evaluate) at the serving shape (B=1024 clouds of 1024 points, m=32)
     against that T-net classifier, with the launch counters around the
     main path: evaluate_samplenet_matched with nn and emd matching, both
     baselines, 12-vote evaluate_classifier_voting on 256 clouds, and the
     in-memory cores of infer_and_dump and evaluate_from_files on a
     progressive sampler (64 clouds, 1024 points); requires
     point_mlp_max, nn_direction, fps, nn_snap and the soft projection's
     forward to have launched; then holds each against the plain path on
     the card (nn matching's points bit for bit; emd matching's points
     those of each path's own transport argmax, bit for bit, and at most
     0.5% of the argmaxes different between the paths, where the f32
     auction's chaos moves the weights, with the near-ties and the
     weights' drift printed; the per-cloud
     NLL within rtol 1e-4 and correctness equal on the clouds whose
     points are equal; the baselines' points bit for bit), and runs
     evaluate_cli in the process on the classifier phase's checkpoints
     (classifier, samplenet nn and emd, baseline fps and random; infer
     and from-files where h5py imports, said on a line of its own);
 18. (compare-registration) holds the soft projection at the registration
     sampler's shape (B=32, N=1024, M=64, k=8: the first path at k=8)
     under its launch plans and one other pair of plans against its plain
     version (idx bit-equal, out within 1e-5, gradients within rtol 1e-4
     / atol 1e-5, the backward bit for bit across plans and runs), and FPS
     at 1024 -> 64 with count 1 (FPSSampler) and with random counts (the
     matching's completion) under its plan and another, bit for bit;
 19. (registration) runs one PCRNet step and one sampler step against a
     seeded frozen PCRNet at full width on the kernel path, the plain path
     and the plain path in float64 from the same state (loss terms within
     rtol 1e-4 of both, each gradient's norm-wise error against f64 at
     most twice the plain f32 path's or 1e-4, the BN-cancelled ones
     round-off), the eval step with the sampler and with FPSSampler on
     both paths (samples bit-equal, errors within rtol 1e-4); then the
     main path, each part with the launch counters reset before it and
     read after: three PCRNet steps, three sampler steps, one eval step
     with the sampler and one with FPSSampler, printing the launches a
     step and requiring point_mlp_exact (fwd, bwd), soft_projection (fwd,
     bwd), nn_direction, point_mlp_max and fps;
 20. (registration-cli) runs `python -m samplenet_tpu_torch.train.
     train_registration --phase pcrnet` for one epoch of 3 steps with
     --fps-eval-sizes 32, then --phase samplenet on its checkpoint; both
     reports finite;
 21. (compare-bf16) holds the two kernels' bf16 modes (bf16 operands,
     f32 sums) against their plain bf16 versions, norm-wise within 1e-3:
     the exact-BN chain (forward, and backward on the kernel forward's own
     state) at B=1024, at a ragged shape and at the reconstruction widths,
     its backward bit for bit from run to run; point_mlp_max at B=1024,
     B=32, ragged N and other widths (a first layer of 16 channels); each
     with the kernel run with bf16 off as a control that must exceed the
     limit;
 22. (bf16) the bf16 modes' main paths, each with the launch counters
     around it: the eval forward with hard matching at B=1024 with
     eval_bf16 (matching bit for bit against the plain matcher on the
     kernel's own simplified cloud); the classification sampler step at
     B=1024 with the exact chain in bf16 (fused_train, fused_mode "exact",
     fused_bf16), held to the plain bf16 step (loss terms within rtol
     1e-3, gradients within 5e-2 norm-wise, which the kernel step with
     bf16 off must exceed), then two steps; the same with the compute
     dtype (SampleNetConfig(bf16=True): tensor ops, no conv kernel) against
     the plain path, then two steps;
 23. (bf16-cli) `train_classifier --bf16` for one epoch of 3 steps and
     `train_samplenet --bf16` on its checkpoint for one of 2;
 24. (data-parallel) spawns 2 gloo ranks sharing the card
     (samplenet_tpu_torch/parallel/launch.py; gloo stages its collectives
     on CUDA tensors through the host), each on its rows of a global
     batch: the classification sampler step at B=1024 (augmented), the
     registration sampler step at B=32, the reconstruction sampler step
     at B=50 (EMD) and the progressive ghost step (bf16, block 4) at B=32
     and at B=28, where a block straddles the ranks, with the launch
     counters reset before them and read after in each rank
     (point_mlp_exact and point_mlp_train fwd and bwd, soft_projection fwd
     and bwd, nn_direction and emd each launched); each held against the
     one-process step on the card from the same seeds: loss terms within
     rtol 1e-5 of the kernel path's (the registration step's within 1e-4
     of the f64 replay of the ranks' own choices), running statistics
     within rtol 1e-4 / atol 1e-6, each gradient's error against the
     one-process f64 step at most twice the one-process plain f32 step's
     (or the track's floor), the ghost steps' norm-wise within
     DP_GHOST_LIMIT of the one-process kernel step's (the same bf16
     roundings), those zero in exact arithmetic round-off; two controls
     must fail those checks: the classification step with the
     statistics' all-reduce taken out of the ranks (each normalising by
     its own rows), and the ghost step at B=28 with the blocks'
     all-reduce skipped (the straddling block from one rank's rows); a
     classification step must issue 17 all-reduces a rank (its wall time
     on the ranks printed, host-staged: no measure of scaling);
     save_sharded from the ranks, restore_sharded here bit for bit and
     one more step; `dryrun_multichip(2)` on the card; then
     `torchrun --nproc-per-node=K -m samplenet_tpu_torch.train.
     train_samplenet --data-parallel` over NCCL, K = min(cards, 2);
 25. (tensor-parallel) spawns a 1 x 2 and a 2 x 2 mesh of gloo ranks
     sharing the card, every layer of 512 or more outputs sharded over
     'model' (parallel/mesh.py::shard_params): on 1 x 2 the vanilla
     classifier step (B=32, 1024 points, 3-64-64-64-128-1024, FC
     512-256-40), the PCRNet step (B=32 pairs), the AE step (B=50, 2048
     points, decoder 256-6144, EMD) and a sampler step at m=256,
     bottleneck 512 (its exact chain on conv5 and bn5 gathered whole),
     with that sampler's eval forward (point_mlp_max on gathered weights,
     fps, nn_direction; its matching bit-equal to the plain path's on
     the rank's simplified points, these within 1e-4 of one process's);
     on 2 x 2 the classifier step; each rank holding its launches (the
     kernels of TP_PATH; the classifier's chains launch none) and its
     (all-reduces, all-gathers) a step to TP_COLLECTIVES, and each step
     to the one-process step as the data-parallel phase holds it (PCRNet
     as the registration step: the f64 replay of the ranks' choices);
     the copy-to-region control (its backward without the all-reduce)
     and the BatchNorm control (statistics over the world, not the data
     group) must fail the gradient check; `dryrun_multichip(4)` (2 x 2)
     on the card; with two or more cards the classifier step under
     `torchrun --nproc-per-node=2 chip_smoke.py --tp-nccl` (1 x 2 over
     NCCL, one rank a card), else a line saying it was not run;
 26. times each kernel, the eval forward and the train steps against the
     plain versions, per call with CUDA events and as device time with
     torch.profiler (the EMD also on the AE step's own pair: the seeded
     AE's reconstruction of the procedural clouds against them), and
     computes each kernel's bound from its inputs (FPS also per call and
     as device time at the eval shape with count = k and at the
     reconstruction FPS baseline's shape, B=50, 2048 -> 64, count 1; the
     soft projection's forward and backward at each of its four paths'
     shapes, with their bounds there; the 1-NN kernel at every shape of
     NN_SHAPES with its plan, bound and issue floor, its device time a
     step of each train path, and at the classification step's two
     Chamfer directions the plain version and the two-call library route,
     torch.cdist then amin, as a yardstick); the
     exact chain's backward at B=1024 and at the reconstruction widths
     also as device time split by pass (forward: dense per layer, pool,
     glue; backward: BN rows, dz/dh_prev, dW, glue); at the registration
     shapes the soft projection (k=8), the exact-BN chain, point_mlp_max
     and FPS (count 1 and the matching's counts) with their bounds and
     launches per step, and the PCRNet step, the sampler step and the two
     eval steps, kernel path against plain path in A B B A order, per
     step, device time and busy share; the bf16 modes against their plain
     bf16 versions (point_mlp_max at B=1024 and B=32 beside the f32
     kernel, the exact chain's forward and backward at B=1024).

Tolerances of the train kernels against their plain versions: outputs and
batch statistics rtol = atol = 1e-4 (point_mlp_exact) and 1e-5 with idx
bit-equal (soft_projection); gradients rtol 1e-3 / atol 1e-5
(point_mlp_exact, at the ragged shape) and rtol 1e-4 / atol 1e-5
(soft_projection). At the train shape the exact-BN chain's lower-layer
gradients are sums over 1M points that BN's correction makes nearly
cancel, so neither f32 path holds an elementwise 1e-3 there; the kernel
is held instead to at least the plain f32 version's accuracy (within 2x)
against the plain version run in float64 on the card; at the
reconstruction track's B*N = 102400 points both f32 paths land about 1e-6
to 1e-4 of scale from f64, and per tensor either can be several times the
other, so there the floor under "2x" is 1e-4 of scale. The EMD kernel, as
tests/test_emd_kernel.py holds the TPU kernel: its cost within rtol 2e-4
of the plain version in float64, and each gradient no further from that
than 1.5x the plain f32 version's own error (or 5e-4 of its scale), by
the largest entry's error and norm-wise; where
the steep auction levels meet near-ties both f32 paths drift from the f64
match. The reconstruction steps: loss terms within rtol 2e-4 of the plain
path (EMD), every gradient's norm-wise error against the f64 path at most
twice the plain f32 path's (or 1e-4). The ghost chain: the kernel and the
plain version in the same mode each against the plain version in float64
with bf16 off (the function both round), the kernel's error at most twice
the plain version's or 1e-4 of scale, by the largest entry and norm-wise;
in bf16 the two sum z in other orders, so a rounding can land one bf16
ulp apart and they are never held to each other elementwise. In bf16
that rule alone lets a kernel that rounds nothing pass (the plain bf16
path lands 0.2-0.3 of scale from f64), so the kernel is also held to the
plain bf16 version on the same block, norm-wise: pooled and statistics
within 1e-3, and the backward kernel's gradients within 1e-3 of the
plain version's VJP run on the kernel forward's own state (its stored
xhat and argmax, so that a one-ulp bf16 flip in the forward does not
move a mask on one side only); the kernel run with bf16 off must exceed
both limits (PERF.md has the readings). The progressive
steps as the classification step; on the ghost chain in bf16 each loss
term's error against the f64 unrounded path is at most twice the plain
bf16 path's (or 1e-2 relative), each prefix accuracy within two clouds of
the plain path's, and every gradient within 5e-2 norm-wise of the plain
bf16 path's, which the kernel step with bf16 off must exceed.

Each phase's seconds follow it on a `[seconds]` line. Any failure raises
and exits non-zero; so does a run without CUDA or outside a checkout. The last three lines are the kernels' JSON summary,
the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B, N, M = 1024, 1024, 32                 # the serving path's shape
WIDTHS = (3, 64, 64, 64, 128, 128)       # per-point MLP at bottleneck 128
RAGGED_B, RAGGED_N, RAGGED_M = 3, 1000, 33
SEED = 0
DEVICE = "cuda"
K = 7                                    # the classification track's k
NUM_CLASSES = 40
TRAIN_STEPS = 5
KERNELS = {   # name -> (source, the Pallas entry point it replaces)
    "nn_direction": ("samplenet_tpu_torch/csrc/nn_direction.cu",
                     "samplenet_tpu/ops/pallas/chamfer_kernel.py:176"),
    "fps": ("samplenet_tpu_torch/csrc/fps.cu",
            "samplenet_tpu/ops/pallas/fps_kernel.py:230"),
    "point_mlp_max": ("samplenet_tpu_torch/csrc/point_mlp_max.cu",
                      "samplenet_tpu/ops/pallas/point_mlp_kernel.py:128"),
}
TRAIN_KERNELS = {  # forward and backward counted apart
    "point_mlp_exact_fwd": (
        "samplenet_tpu_torch/csrc/point_mlp_train.cu",
        "samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499"),
    "point_mlp_exact_bwd": (
        "samplenet_tpu_torch/csrc/point_mlp_train.cu",
        "samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499"),
    "soft_projection_fwd": (
        "samplenet_tpu_torch/csrc/soft_projection.cu",
        "samplenet_tpu/ops/pallas/soft_projection_kernel.py:161"),
    "soft_projection_bwd": (
        "samplenet_tpu_torch/csrc/soft_projection.cu",
        "samplenet_tpu/ops/pallas/soft_projection_kernel.py:161"),
}
RECON_KERNELS = {
    "emd": ("samplenet_tpu_torch/csrc/emd.cu",
            "samplenet_tpu/ops/pallas/emd_kernel.py:269"),
}
# zero gradient in exact arithmetic: dense biases followed by BN, and the
# last conv BN's beta (a shift of every pooled feature that fc1's BN undoes)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
# the reconstruction track (train/reconstruction.py:36-55, 141-156 of the
# JAX package): B=50 clouds of 2048 points, the AE's and the sampler's
# conv widths, m=64 sampled points, k=16
RECON_B, RECON_N, RECON_M, RECON_K = 50, 2048, 64, 16
RECON_WIDTHS = (3, 64, 128, 128, 256, 128)
RECON_STEPS = 3
RECON_PATH = ("emd", "point_mlp_exact_fwd", "point_mlp_exact_bwd",
              "point_mlp_max", "nn_direction", "fps", "soft_projection_fwd",
              "soft_projection_bwd")
# the progressive track (train/progressive.py:50-71 and :227-241 of the JAX
# package): B=32 clouds of 1024 points, sizes 8..1024 (8 prefixes), k=7,
# against the frozen PointNet; the AE variant at B=50, 2048 points, sizes
# 16..2048, k=16, against the reconstruction AE
PROG_B, PROG_N, PROG_MAX = 32, 1024, 1024
PROG_STEPS = 2                 # per chain (exact, ghost) on the main path
# the ghost chain in bf16 against the plain bf16 version on the same block,
# worst norm-wise over six inputs (NVIDIA H100, PERF.md): the outputs read
# up to 2.6e-4, the kernel with bf16 off 4.5e-3 or more; the backward on
# the kernel forward's own state up to 4.1e-4, bf16 off 7.6e-3 or more, and
# each kernel that leaves out one of its roundings 3.7e-3 or more; the
# step's gradients 0.016, bf16 off 0.43
GHOST_BF16_OUT, GHOST_BF16_BWD, GHOST_BF16_STEP = 1e-3, 1e-3, 5e-2
PROG_KERNELS = {
    "nn_snap": ("samplenet_tpu_torch/csrc/nn_direction.cu",
                "samplenet_tpu/ops/pallas/chamfer_kernel.py:192"),
    "point_mlp_train_fwd": (
        "samplenet_tpu_torch/csrc/point_mlp_train.cu",
        "samplenet_tpu/ops/pallas/point_mlp_train_kernel.py:400"),
    "point_mlp_train_bwd": (
        "samplenet_tpu_torch/csrc/point_mlp_train.cu",
        "samplenet_tpu/ops/pallas/point_mlp_train_kernel.py:400"),
}
# the registration track (train/registration.py:28-53 and
# train_registration.py:33-86 of the JAX package): B=32 pairs of 1024-point
# clouds rotated up to 45 degrees about each axis; the sampler m=64,
# bottleneck 128, k=8, sigma = max(t^2, 1e-2), both clouds sampled, alpha =
# lmbda = 0.01, against PCRNet (no BN, bottleneck 1024, FC 2048->1024->
# 1024->512->512->256->7)
REG_B, REG_N, REG_M, REG_K = 32, 1024, 64, 8
REG_STEPS = 3                  # per phase on the main path
REG_PATH = ("point_mlp_exact_fwd", "point_mlp_exact_bwd",
            "soft_projection_fwd", "soft_projection_bwd", "nn_direction",
            "point_mlp_max", "fps")
# the soft projection's (B, N, M, k) on each path that runs it
FPS_TIMES = {   # (B, N, k, count = k): FPS timed beside the main shape's
    "eval shape": (B, N, M, True),
    "reconstruction FPS baseline's shape": (RECON_B, RECON_N, RECON_M, False),
}
# a long cloud at a small B: the backward holds no cloud in shared memory
SOFT_LONG = (2, 16384, 64, 16)
SOFT_SHAPES = {
    "classification step": (B, N, M, K),
    "reconstruction sampler step": (RECON_B, RECON_N, RECON_M, RECON_K),
    "progressive step": (PROG_B, PROG_N, PROG_MAX, K),
    "progressive AE step": (RECON_B, RECON_N, RECON_N, RECON_K),
}
# the 1-NN kernel's (B, N1 queries, N2 points, snap) on every path: the
# eval forward's matching and the Chamfer loss's two directions (B=1024),
# the reconstruction sampler's losses (64 over 2048 and back), the
# progressive Chamfer losses at each prefix size s, both ways (classification
# 8..1024 over 1024; AE 16..2048 over 2048, the AE's Chamfer 2048 over 2048),
# the progressive infer step's snap, and the registration steps (B=32):
# PCRNet's Chamfer on full clouds, the sampler's simplification loss (64
# over 1024 and back, each cloud) and PCRNet's Chamfer on the samples and
# the sampling consistency (64 over 64)
NN_SHAPES = {
    "eval and Chamfer direction 1": (B, M, N, False),
    "Chamfer direction 2": (B, N, M, False),
    f"recon sampler, {RECON_M} over {RECON_N}": (RECON_B, RECON_M, RECON_N,
                                                  False),
    f"recon sampler, {RECON_N} over {RECON_M}": (RECON_B, RECON_N, RECON_M,
                                                  False),
    **{name: shape for s in (8, 16, 32, 64, 128, 256, 512) for name, shape in (
        (f"progressive cls, {s} over {PROG_N}", (PROG_B, s, PROG_N, False)),
        (f"progressive cls, {PROG_N} over {s}", (PROG_B, PROG_N, s, False)))},
    f"progressive cls, {PROG_N} over {PROG_N}": (PROG_B, PROG_N, PROG_N,
                                                 False),
    **{name: shape for s in (16, 32, 64, 128, 256, 512, 1024)
       for name, shape in (
           (f"progressive AE, {s} over {RECON_N}", (RECON_B, s, RECON_N,
                                                    False)),
           (f"progressive AE, {RECON_N} over {s}", (RECON_B, RECON_N, s,
                                                    False)))},
    f"progressive AE, {RECON_N} over {RECON_N}": (RECON_B, RECON_N, RECON_N,
                                                  False),
    "nn_snap, progressive infer": (PROG_B, PROG_N, PROG_N, True),
    f"registration PCRNet step, {REG_N} over {REG_N}": (REG_B, REG_N, REG_N,
                                                        False),
    **{f"registration sampler step, {a} over {c}": (REG_B, a, c, False)
       for a, c in ((REG_M, REG_N), (REG_N, REG_M), (REG_M, REG_M))},
}
PROG_PATH = ("nn_snap", "point_mlp_train_fwd", "point_mlp_train_bwd",
             "point_mlp_exact_fwd", "point_mlp_exact_bwd",
             "soft_projection_fwd", "soft_projection_bwd", "nn_direction",
             "fps", "point_mlp_max")
# the classification track's own classifier: the T-net PointNet at its
# published widths (40 classes) at B=32 clouds of 1024 points; its f32
# step's gradients held to 2x the CPU f32 step's norm-wise error against
# float64 (or the floor where both are below it), and under the cap. In
# f32 the BN backward over 32768 rows cancels: the lower layers' gradients
# land 2.5e-3 to 5.1e-3 norm-wise from f64 on the card and on the CPU
# alike, and as far from each other, while the f64 step moves 1e-6 when
# each input coordinate moves 1e-7 (NVIDIA H100, PERF.md)
CLS_B = 32
CLS_GRAD_FLOOR = 1e-5
CLS_GRAD_CAP = 1e-2
CLS_TIMED = 10                 # train steps timed after warm-up
# EMD matching on the kernel and the plain path, whose simplified clouds
# differ by 3e-7: the auction is chaotic in f32 (its steep levels multiply
# d2's difference by up to 65536), and the two paths' transport weights at
# the same pick differ by up to 22%; 22 of the 32768 argmaxes differ, one
# where the best led the second by 2.9% (NVIDIA H100, PERF.md). Each path
# is held to its own argmax exactly, and the share that differs to this
EMD_FLIP_SHARE = 5e-3
# the kernels the evaluation protocols launch (train/evaluate.py)
EVAL_PATH = ("point_mlp_max", "nn_direction", "fps", "nn_snap",
             "soft_projection_fwd")
# the two kernels' bf16 modes, counted under their own names: the exact-BN
# chain with bf16 operands (fused_bf16 with the exact mode) and the eval
# chain with bf16 operands (the TPU kernel's default; eval_bf16)
BF16_KERNELS = {
    "point_mlp_max_bf16": ("samplenet_tpu_torch/csrc/point_mlp_max.cu",
                           "samplenet_tpu/ops/pallas/point_mlp_kernel.py:128"),
    "point_mlp_exact_bf16_fwd": (
        "samplenet_tpu_torch/csrc/point_mlp_train.cu",
        "samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499"),
    "point_mlp_exact_bf16_bwd": (
        "samplenet_tpu_torch/csrc/point_mlp_train.cu",
        "samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py:499"),
}
# each bf16 kernel against its plain bf16 version, norm-wise, as the ghost
# chain (the exact chain's backward on the kernel forward's own state); the
# kernel with bf16 off must exceed it
BF16_TOL = 1e-3
BF16_STEPS = 2                 # per train configuration on the main path
# the serving artifact: a frozen torch.export program of the eval forward
# at the daemon's default batch; the f32 point_mlp_max's digest on
# tools/time_exact_chain.py's inputs (PR 16, PERF.md), which the op must keep
ARTIFACT_B = 256
MAX_DIGEST = "ea0490ae91c9"
ARTIFACT_OPS = ("samplenet.point_mlp_max.default",
                "samplenet.nn_direction.default", "samplenet.fps.default")
# the card's published peaks (NVIDIA H100 SXM data sheet), and its
# special-function rate: 16 exp2 / rsqrt / rcp results
# per SM per clock on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), 132 SMs at the 1.98 GHz boost clock
# the kernel whose dense layers run on the tensor cores (mma_tile.cuh)
TENSOR_CORE_KERNELS = ("point_mlp_max_kernel",)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12       # dense, on the tensor cores
BF16_FLOP_PER_S = 989e12       # dense, on the tensor cores
SFU_OP_PER_S = 16 * 132 * 1.98e9
# issue slots: 4 warp schedulers an SM, each one instruction for 32 lanes a
# clock, 132 SMs at 1.98 GHz
LANE_ISSUE_PER_S = 4 * 32 * 132 * 1.98e9
RATE_NAMES = {FP32_FLOP_PER_S: "FP32", TF32_FLOP_PER_S: "TF32",
              BF16_FLOP_PER_S: "BF16", SFU_OP_PER_S: "SFU"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ phases

def phase_env(torch) -> str:
    card = card_line()
    log("env", f"card: {card}")
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"cuda {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)}, "
               f"count {torch.cuda.device_count()}")
    from samplenet_tpu_torch.ops.cuda._build import find_nvcc

    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    log("env", f"nvcc {nvcc}: {ver[-1]}")
    try:
        import triton
        log("env", f"triton {triton.__version__} imports")
    except ImportError as exc:
        log("env", f"triton does not import ({exc})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", "TF32 off for matmul and cuDNN")
    return card


def phase_build() -> dict[tuple[int, int, bool], float]:
    from samplenet_tpu_torch.ops.cuda import _build

    path, seconds = _build.build()
    log("build", f"{path.relative_to(HERE)} built from "
                 f"{[s.name for s in _build._sources()]} in {seconds:.1f} s "
                 f"(one nvcc {' '.join(_build.NVCC_FLAGS)} -c per source, "
                 f"all at once, then nvcc {' '.join(_build.LINK_FLAGS)})")
    nn, key = {}, None         # the 1-NN kernel's 48 entries, summarised
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Compiling entry" in line:
            m = re.search(r"nn_direction_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          line)
            key = None if m is None else tuple(map(int, m.groups()))
        if key is not None:
            m = re.search(r"Used (\d+) registers|(\d+) bytes spill stores",
                          line)
            if m:
                nn.setdefault(key, []).append(m.group(1) or m.group(2))
        elif any(k in line for k in ("registers", "Compiling entry",
                                     "spill")):
            log("build", line.strip())
    log("build", "nn_direction_kernel (lanes, queries, snap): [spill bytes, "
                 "registers] " + ", ".join(f"{k} {v}"
                                           for k, v in sorted(nn.items())))
    funcs = _sass(_build.find_nvcc(), path)
    for key in TENSOR_CORE_KERNELS:
        mine = {name: sum("HMMA" in ins for _, ins in code)
                for name, code in funcs.items() if key in name}
        log("build", f"{key}: HMMA instructions in the SASS per "
                     f"instantiation {mine}")
        if not mine or any(c == 0 for c in mine.values()):
            raise AssertionError(f"{key}: an instantiation without HMMA "
                                 f"instructions: {mine}")
    costs = nn_pair_costs(funcs)
    log("build", f"nn_direction_kernel: SASS lane-instructions a pair in "
                 f"the innermost loop, by (lanes, queries, snap): "
                 + ", ".join(f"{k} {v:.3f}" for k, v in sorted(costs.items())))
    if len(costs) != 2 * 6 * 4:
        raise AssertionError(f"nn_direction_kernel: {len(costs)} of 48 "
                             f"instantiations have a pair loop in the SASS")
    _build.library()
    return costs
    _build.library()


def _sass(nvcc: str, lib_path) -> dict[str, list[tuple[int, str]]]:
    """Each kernel's SASS in the built library (cuobjdump from the toolkit
    of nvcc): mangled name -> [(address, instruction)]."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def nn_pair_cost(code: list[tuple[int, str]]) -> float | None:
    """Lane-instructions a (query, point) pair in a 1-NN kernel's SASS: the
    instructions of its innermost loop holding min.NaN (FMNMX), over the
    FMNMX in it (one a pair); the loop with the most pairs where several
    are innermost (an unrolled body and its remainder)."""
    loops = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*0x([0-9a-f]+)$", ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        if any(lo <= a <= b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue                      # not innermost
        body = [ins for a, ins in code if lo <= a <= hi]
        pairs = sum("FMNMX" in ins for ins in body)
        if pairs and (best is None or pairs > best[0]):
            best = (pairs, len(body))
    return None if best is None else best[1] / best[0]


def nn_pair_costs(funcs) -> dict[tuple[int, int, bool], float]:
    """`nn_pair_cost` of each instantiation of the 1-NN kernel in `funcs`
    (`_sass`), by (lanes, queries, snap)."""
    out = {}
    for name, code in funcs.items():
        m = re.search(r"nn_direction_kernelILi(\d+)ELi(\d+)ELb([01])E", name)
        cost = nn_pair_cost(code) if m else None
        if cost is not None:
            out[(int(m.group(1)), int(m.group(2)), m.group(3) == "1")] = cost
    return out


def nn_issue_floor(b: int, n1: int, n2: int, per_pair: float) -> float:
    """ms the card's issue slots need for b * n1 * n2 pairs at `per_pair`
    lane-instructions each."""
    return per_pair * b * n1 * n2 / LANE_ISSUE_PER_S * 1e3


def _mlp_weights(torch, rng, device, widths=WIDTHS):
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        wbs += [torch.from_numpy(w).to(device), torch.from_numpy(b).to(device)]
    return tuple(wbs)


def _inputs(torch, rng, device, b, n, m):
    x = torch.from_numpy(rng.standard_normal((b, m, 3)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    given = torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32))
    count = torch.from_numpy(rng.integers(1, m + 1, b).astype(np.int32))
    return [t.to(device) for t in (x, y, given, count)]


def phase_compare(torch) -> dict[str, float]:
    """Kernel vs plain on the card; returns max |error| at the main shape."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        nn_direction_plain,
        point_mlp_max,
        point_mlp_max_plain,
    )

    rng = np.random.default_rng(SEED)
    errs = {}
    for label, (b, n, m) in (("main", (B, N, M)),
                             ("ragged", (RAGGED_B, RAGGED_N, RAGGED_M))):
        x, y, given, count = _inputs(torch, rng, DEVICE, b, n, m)
        dk, ik = nn_direction(x, y)
        dp, ip = nn_direction_plain(x, y)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
            raise AssertionError(
                f"nn_direction {label}: kernel != plain "
                f"({int((ik != ip).sum())} idx differ, max |d| "
                f"{float((dk - dp).abs().max())})")
        log("compare", f"nn_direction {label} x{tuple(x.shape)} "
                       f"y{tuple(y.shape)}: dist and idx bit-equal")

        ik2, xk = fps(y, given, count, m)
        ip2, xp = fps_plain(y, given, count, m)
        torch.cuda.synchronize()
        if not (torch.equal(ik2, ip2) and torch.equal(xk, xp)):
            raise AssertionError(
                f"fps {label}: kernel != plain "
                f"({int((ik2 != ip2).sum())} idx differ)")
        log("compare", f"fps {label} points{tuple(y.shape)} k={m}, count "
                       f"{int(count.min())}..{int(count.max())}: idx and "
                       f"xyz bit-equal")

        wbs = _mlp_weights(torch, rng, DEVICE)
        pk = point_mlp_max(y, wbs)
        pp = point_mlp_max_plain(y, wbs)
        torch.cuda.synchronize()
        torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
        err = float((pk - pp).abs().max())
        log("compare", f"point_mlp_max {label} x{tuple(y.shape)} widths "
                       f"{WIDTHS}: max |kernel - plain| {err!r} "
                       f"(rtol = atol = 1e-4); {_f64_reading(torch, y, wbs, pk, pp)}")
        if label == "main":
            errs = {"nn_direction": float((dk - dp).abs().max()),
                    "fps": float((xk - xp).abs().max()),
                    "point_mlp_max": err}
    return errs


def _f64_reading(torch, x, wbs, k, p) -> str:
    """point_mlp_max's kernel and plain f32 outputs against the plain
    version in float64, each as its largest entry's error relative to the
    largest output."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_max_plain

    r = point_mlp_max_plain(x.double(), tuple(t.double() for t in wbs))
    return (f"against f64: kernel {_rel_err(k, r)!r}, plain f32 "
            f"{_rel_err(p, r)!r} of scale")


def _same_bits(torch, a, c) -> bool:
    return torch.equal(a.view(torch.int32), c.view(torch.int32))


def _same_or_nan(torch, a, c) -> bool:
    return (torch.equal(a.isnan(), c.isnan())
            and torch.equal(a.masked_fill(a.isnan(), 0),
                            c.masked_fill(c.isnan(), 0)))


def phase_compare_nan(torch) -> None:
    """FPS and the 1-NN kernels against their plain versions on clouds with
    NaN and +-inf coordinates, at the serving path's shape: FPS idx equal
    and xyz bit for bit (NaN ranks above every number and propagates
    through the running minimum); nn_direction and nn_snap idx equal, dist
    equal with NaN at the same places (a NaN distance comes first, as in
    the JAX package's chunked_min_argmin), snapped points bit for bit."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        nn_direction_plain,
        nn_snap,
        nn_snap_plain,
    )

    rng = np.random.default_rng(SEED + 5)
    x, y, given, count = _inputs(torch, rng, DEVICE, B, N, M)
    nan, inf = float("nan"), float("inf")
    y[0:256, 5, 1] = nan                  # a NaN point, picked by argmax
    y[256:512, 7, 0] = nan                # a NaN point given first
    given[256:512, 0] = 7
    y[512:520] = nan                      # clouds all NaN
    y[600:700, 11, 2] = inf               # +-inf coordinates
    y[700:800, 12] = -inf
    x[900:910, 3] = nan                   # NaN queries
    for label, cnt in (("random counts", count),
                       ("count 1", torch.ones_like(count)),
                       (f"count {M}", torch.full_like(count, M))):
        ik, xk = fps(y, given, cnt, M)
        ip, xp = fps_plain(y, given, cnt, M)
        torch.cuda.synchronize()
        if not (torch.equal(ik, ip) and _same_bits(torch, xk, xp)):
            raise AssertionError(f"fps on NaN/inf clouds ({label}): kernel "
                                 f"!= plain ({int((ik != ip).sum())} idx "
                                 f"differ)")
        log("compare", f"fps NaN/inf clouds points{tuple(y.shape)} k={M}, "
                       f"{label}: idx and xyz bits equal; clouds picking "
                       f"the NaN point {int((ik[:256] == 5).any(1).sum())}"
                       f"/{ik[:256].shape[0]}")
    dk, ik = nn_direction(x, y)
    dp, ip = nn_direction_plain(x, y)
    sk = nn_snap(x, y)
    sp = nn_snap_plain(x, y)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and _same_or_nan(torch, dk, dp)
            and torch.equal(sk[1], sp[1]) and _same_or_nan(torch, sk[0], sp[0])
            and _same_bits(torch, sk[2], sp[2])):
        raise AssertionError(f"nn_direction/nn_snap on NaN/inf clouds: "
                             f"kernel != plain ({int((ik != ip).sum())} idx "
                             f"differ)")
    if not ((ik[0:256] == 5).all() and (ik[900:910, 3] == 0).all()):
        raise AssertionError("nn_direction: a NaN distance did not come first")
    log("compare", f"nn_direction and nn_snap NaN/inf clouds x{tuple(x.shape)}"
                   f" y{tuple(y.shape)}: idx equal, dist equal with NaN in "
                   f"{int(dk.isnan().sum())} places, snapped bits equal")


def other_nn_plan(plan, n1: int, n2: int):
    """A plan unlike `plan`: one lane a query where it takes several, else
    32; eight queries a thread where it takes fewer, else one."""
    from samplenet_tpu_torch.ops.cuda import nn_plan as npl

    return npl.make(n1, n2, 32 if plan.lanes == 1 else 1,
                    8 if plan.queries < 8 else 1)


def phase_compare_nn(torch) -> None:
    """nn_direction and nn_snap at every shape the paths give them
    (NN_SHAPES), under the planned launch and one other plan, each bit for
    bit against the plain version: dist, idx and the snapped points."""
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck

    rng = np.random.default_rng(SEED + 7)
    shapes = sorted({v[:3] for v in NN_SHAPES.values()})
    for b, n1, n2 in shapes:
        x, y = _randn(torch, rng, b, n1, 3), _randn(torch, rng, b, n2, 3)
        ref = ck.nn_snap_plain(x, y)
        plan = ck.kernel_plan(x.device.index, b, n1, n2)
        other = other_nn_plan(plan, n1, n2)
        for p in (plan, other):
            for snap in (False, True):
                out = ck.launch(x, y, p, snap)
                if not all(torch.equal(a, c) for a, c in zip(out, ref)):
                    raise AssertionError(
                        f"{'nn_snap' if snap else 'nn_direction'} B={b}, "
                        f"{n1} over {n2}, {p}: kernel != plain "
                        f"({int((out[1] != ref[1]).sum())} idx differ)")
        del x, y, ref
    torch.cuda.empty_cache()
    log("compare", f"nn_direction and nn_snap at the paths' {len(shapes)} "
                   f"shapes (B, N1, N2) {shapes}, each under its plan and "
                   f"one other: dist, idx and snapped bit-equal to the "
                   f"plain version")


def make_model(torch, device):
    """SampleNet(32, 128) with seeded weights and perturbed BN statistics,
    so eval BN is not the identity."""
    from samplenet_tpu_torch.models import SampleNet
    from samplenet_tpu_torch.nn.layers import BatchNorm

    net = SampleNet(num_out_points=M, bottleneck_size=128,
                    generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)

    def noise(c: int):
        return torch.from_numpy(
            (0.1 * rng.standard_normal(c)).astype(np.float32))

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.weight.add_(noise(c))
                mod.bias.add_(noise(c))
                mod.running_mean.add_(noise(c))
                mod.running_var.copy_((mod.running_var + noise(c)).abs() + 0.5)
    return net.to(device).eval()


def phase_end_to_end(torch, model, clouds) -> dict[str, int]:
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.fps import gather_point
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds
    from samplenet_tpu_torch.serving import BatchedSampler

    x = torch.from_numpy(clouds).to(DEVICE)
    with torch.inference_mode():
        simp_k, matched_k = model(x)
        pts_k, idx_k = nn_match_from_clouds(x, simp_k, M)
        with plain_on_cuda():
            simp_p = model.simplify(x)
            pts_p, idx_p = nn_match_from_clouds(x, simp_k, M)
    torch.cuda.synchronize()
    if simp_k.shape != (B, M, 3) or matched_k.shape != (B, M, 3) \
            or not bool(torch.isfinite(simp_k).all()):
        raise AssertionError(f"bad shapes or values: {simp_k.shape}, "
                             f"{matched_k.shape}")
    torch.testing.assert_close(simp_k, simp_p, rtol=1e-4, atol=1e-4)
    log("e2e", f"simplified [B={B}, {M}, 3]: kernel vs plain path max |d| "
               f"{float((simp_k - simp_p).abs().max())!r} (tol 1e-4)")
    if not (torch.equal(idx_k, idx_p) and torch.equal(pts_k, pts_p)
            and torch.equal(matched_k, pts_k)):
        raise AssertionError("matching: kernel path != plain matcher")
    if not torch.equal(gather_point(x, idx_k), pts_k):
        raise AssertionError("matched points are not the input's rows")
    uniq = min(len(torch.unique(r)) for r in idx_k.cpu())
    log("e2e", f"matched idx and points equal the plain matcher's on the "
               f"kernel path's simplified cloud; every matched point is an "
               f"input row; min unique per cloud {uniq}/{M}")
    # a simplified cloud whose second half repeats its first: the matcher
    # de-duplicates and the FPS kernel completes by argmax picks
    dup = torch.cat([simp_k[:, : M // 2], simp_k[:, : M // 2]], dim=1)
    with torch.inference_mode():
        pts_dk, idx_dk = nn_match_from_clouds(x, dup, M)
        with plain_on_cuda():
            pts_dp, idx_dp = nn_match_from_clouds(x, dup, M)
    if not (torch.equal(idx_dk, idx_dp) and torch.equal(pts_dk, pts_dp)):
        raise AssertionError("matching with FPS completion: kernel != plain")
    log("e2e", f"with {M // 2} duplicated simplified points per cloud, the "
               f"FPS-completed idx and points equal the plain matcher's")

    # the serving path itself, with the launch counters read around it
    sampler = BatchedSampler(model, max_batch=B, num_points=N, device=DEVICE)
    reset_launch_counts()
    served = sampler(clouds)
    torch.cuda.synchronize()
    counts = launch_counts()
    log("e2e", f"BatchedSampler(max_batch={B}) on {len(clouds)} clouds: "
               f"kernel launches {counts}")
    missing = [k for k in KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if not np.array_equal(served, matched_k.cpu().numpy()):
        raise AssertionError("BatchedSampler != direct forward")
    return counts


def _start_server(source: list[str]):
    """`python -m samplenet_tpu_torch.serve` on `source` (--weights or
    --artifact) at port 0; (process, port)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "samplenet_tpu_torch.serve", *source,
         "--device", DEVICE, "--num-points", str(N), "--max-batch", "256",
         "--port", "0"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()

    def pump():  # keeps the pipe drained for the server's whole life
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + 180
    seen = []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        seen.append(line)
        if line.startswith("serving sampler"):
            return proc, int(line.rsplit(":", 1)[1])
    proc.kill()
    raise RuntimeError("serve did not start:\n" + "".join(seen[-40:]))


def phase_serve(torch, model, weights: str) -> None:
    from samplenet_tpu_torch.serving import BatchedSampler

    proc, port = _start_server(["--weights", weights])
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        log("serve", f"GET /healthz: {meta}")
        rng = np.random.default_rng(SEED + 2)
        reqs = [rng.standard_normal((16, N, 3)).astype("<f4")
                for _ in range(4)]

        def post(c):
            req = urllib.request.Request(f"{base}/sample", data=c.tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return np.frombuffer(r.read(), "<f4").reshape(len(c), M, 3)

        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(post, reqs))
        direct = BatchedSampler(model, max_batch=256, num_points=N,
                                device=DEVICE)
        for i, (c, got) in enumerate(zip(reqs, answers)):
            if not np.array_equal(got, direct(c)):
                raise AssertionError(f"request {i}: served != direct")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        counts = meta["kernel_launches"]
        missing = [k for k in KERNELS if counts.get(k, 0) < 1]
        if missing or meta["requests_served"] != 64:
            raise AssertionError(f"server: missing {missing}, meta {meta}")
        log("serve", f"{len(reqs)} concurrent POST /sample, "
                     f"{sum(len(c) for c in reqs)} clouds: bit-equal to a "
                     f"direct BatchedSampler call; server kernel launches "
                     f"{counts}")
    finally:
        _stop(proc)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def _max_digest(torch) -> str:
    """SHA-1 of the f32 point_mlp_max at tools/time_exact_chain.py's
    inputs, through the wrapper and its op."""
    import hashlib

    from samplenet_tpu_torch.ops.cuda import point_mlp_max

    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(
        np.float32)).to(DEVICE)
    wbs = _mlp_weights(torch, rng, DEVICE)
    out = point_mlp_max(y, wbs).cpu().numpy()
    return hashlib.sha1(out.tobytes()).hexdigest()[:12]


def phase_artifact(torch, model, weights: str, tmp: str) -> None:
    """The serving artifact: `serve --export-artifact` on the card, the
    program exported and loaded in the process (their seconds), its graph,
    its output against a direct BatchedSampler bit for bit with the launch
    counters around it, and `serve --artifact` answering 4 concurrent
    POSTs bit-equal to BatchedSampler, launching all three eval kernels."""
    import io

    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.serving import (
        ArtifactSampler,
        BatchedSampler,
        read_artifact,
        save_exported,
    )

    bits = _max_digest(torch)
    if bits != MAX_DIGEST:
        raise AssertionError(f"point_mlp_max through its op: digest {bits}, "
                             f"PR 16 recorded {MAX_DIGEST}")
    log("artifact", f"f32 point_mlp_max through samplenet::point_mlp_max: "
                    f"digest {bits}, PR 16's")
    art = os.path.join(tmp, "sampler_cli.sntpt")
    _, cli_s = _cli(["samplenet_tpu_torch.serve", "--weights", weights,
                     "--device", DEVICE, "--num-points", str(N),
                     "--max-batch", str(ARTIFACT_B), "--export-artifact",
                     art], "serve --export-artifact")
    t0 = time.monotonic()
    save_exported(os.path.join(tmp, "sampler.sntpt"), model,
                  batch=ARTIFACT_B, num_points=N, freeze_params=True,
                  device=DEVICE, metadata={"num_out_points": M})
    export_s = time.monotonic() - t0
    header, blob = read_artifact(art)
    program = torch.export.load(io.BytesIO(blob))
    ops = sorted({str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("samplenet.")})
    if ops != sorted(ARTIFACT_OPS) \
            or torch.device(header["device"]).type != DEVICE:
        raise AssertionError(f"artifact: ops {ops}, header {header}")
    t0 = time.monotonic()
    sampler = ArtifactSampler(art, DEVICE)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    clouds = np.random.default_rng(SEED + 6).standard_normal(
        (ARTIFACT_B, N, 3)).astype(np.float32)
    reset_launch_counts()
    t0 = time.monotonic()
    first = sampler(clouds)
    first_s = time.monotonic() - t0
    counts = launch_counts()
    direct = BatchedSampler(model, max_batch=ARTIFACT_B, num_points=N,
                            device=DEVICE)
    if not np.array_equal(first, direct(clouds)):
        raise AssertionError("artifact in the process != BatchedSampler")
    missing = [k for k in KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the artifact launched no {missing}: {counts}")
    log("artifact", f"B={ARTIFACT_B}, N={N}, m={M} on {header['device']} "
                    f"({len(blob)} bytes): serve --export-artifact "
                    f"{cli_s:.2f} s (process included), save_exported in "
                    f"the process {export_s:.2f} s, ArtifactSampler load "
                    f"{load_s:.2f} s, first call {first_s:.3f} s; graph "
                    f"ops {ops}; bit-equal to BatchedSampler; launches "
                    f"{counts}")
    proc, port = _start_server(["--artifact", art])
    try:
        base = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(SEED + 7)
        reqs = [rng.standard_normal((16, N, 3)).astype("<f4")
                for _ in range(4)]

        def post(c):
            req = urllib.request.Request(f"{base}/sample", data=c.tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return np.frombuffer(r.read(), "<f4").reshape(len(c), M, 3)

        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(post, reqs))
        for i, (c, got) in enumerate(zip(reqs, answers)):
            if not np.array_equal(got, direct(c)):
                raise AssertionError(f"artifact request {i}: served != "
                                     f"direct")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        served = meta["kernel_launches"]
        missing = [k for k in KERNELS if served.get(k, 0) < 1]
        if missing or meta["requests_served"] != 64 \
                or meta["artifact"]["frozen_params"] is not True:
            raise AssertionError(f"artifact server: missing {missing}, "
                                 f"meta {meta}")
        log("artifact", f"serve --artifact: {len(reqs)} concurrent POST "
                        f"/sample, 64 clouds, bit-equal to a direct "
                        f"BatchedSampler; server kernel launches {served}")
    finally:
        _stop(proc)


def phase_ae_analysis(torch, data) -> None:
    """ae_analysis at the reconstruction shape (B=50 clouds of 2048 points,
    the seeded AE at its published widths): nn_distances_per_cloud on 64
    FPS-sampled points a cloud, kernel path against plain_on_cuda() (the
    1-NN indices of both directions equal, the per-cloud distances bit for
    bit, nn_direction launched), and reconstructions_from_sampled of the
    full clouds, where the encoder is point_mlp_max (within 1e-4 of the
    plain path, point_mlp_max's tolerance)."""
    from samplenet_tpu_torch.models import ae_analysis
    from samplenet_tpu_torch.ops.chamfer import nn_distance
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points

    ae, _, _ = _recon_state(torch, "ae")
    ae.eval()
    x = torch.from_numpy(data).to(DEVICE)
    _, s = farthest_point_sample_with_points(RECON_M, x)
    samples = s.cpu().numpy()
    runs = {}
    for plain in (False, True):
        reset_launch_counts()
        with _ctx(plain):
            dist = ae_analysis.nn_distances_per_cloud(ae, data, samples,
                                                      batch_size=RECON_B)
            with torch.no_grad():
                _, i1, _, i2 = nn_distance(ae(s), x)
            recon = ae_analysis.reconstructions_from_sampled(ae, data)
        torch.cuda.synchronize()
        runs[plain] = (dist, i1, i2, recon, launch_counts())
    (dk, i1k, i2k, rk, counts), (dp, i1p, i2p, rp, plain_counts) = \
        runs[False], runs[True]
    if not (torch.equal(i1k, i1p) and torch.equal(i2k, i2p)):
        raise AssertionError("ae_analysis: 1-NN indices differ from plain")
    if not np.array_equal(dk, dp) or not np.isfinite(dk).all():
        raise AssertionError(f"nn_distances_per_cloud: {dk[:4]} kernel, "
                             f"{dp[:4]} plain")
    np.testing.assert_allclose(rk, rp, rtol=1e-4, atol=1e-4)
    for k in ("nn_direction", "point_mlp_max"):
        if counts.get(k, 0) < 1 or plain_counts.get(k, 0):
            raise AssertionError(f"ae_analysis launches: {counts}, plain "
                                 f"{plain_counts}")
    log("ae_analysis", f"B={RECON_B}, {RECON_N} points, {RECON_M} sampled: "
                       f"nn_distances_per_cloud bit-equal to plain_on_cuda "
                       f"(mean {float(dk.mean())!r}), 1-NN indices equal "
                       f"both ways; reconstructions_from_sampled of the "
                       f"full clouds max |d| {float(np.abs(rk - rp).max())!r}"
                       f" (tol 1e-4); launches {counts}")


def _time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pair_ms(torch, kernel_fn, plain_fn, iters):
    """Alternating plain, kernel, kernel, plain; mean of each pair."""
    p1 = _time_ms(torch, plain_fn, iters)
    k1 = _time_ms(torch, kernel_fn, iters)
    k2 = _time_ms(torch, kernel_fn, iters)
    p2 = _time_ms(torch, plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the CUDA kernels' own time under
    torch.profiler, free of the host's launch overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler now and then records no kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("torch.profiler recorded no device time, 3 times")


def _profile_top(torch, fn, iters: int, top: int = 8) -> str:
    """The `top` CUDA kernels by device time per call under torch.profiler,
    and the rest, as "name ms (share)"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / iters / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(ms for ms, _ in rows)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    parts = [f"{name[:60]} {ms!r} ms ({ms / total:.1%})"
             for ms, name in rows[:top]]
    rest = sum(ms for ms, _ in rows[top:])
    return (f"{total!r} ms device per call: " + "; ".join(parts)
            + f"; {len(rows) - top} other kernels {rest!r} ms "
              f"({rest / total:.1%})")


# (label, kernel name key) of each pass; the first runs once per layer
BWD_PASSES = (("rows", "pmt_rows"), ("dz/dh_prev", "pmt_bwd_dz"),
              ("dW", "pmt_bwd_dw"), ("one-pass bwd", "pmt_bwd_kernel"),
              ("dense (rstd recompute)", "pmt_dense"))
FWD_PASSES = (("dense", "pmt_dense"), ("pool", "pmt_pool"))


def _split_line(kernels, iters: int, layers: int,
                passes=BWD_PASSES) -> tuple[str, bool]:
    """The `_pass_split` line from (kernel name, ms) in launch order over
    `iters` calls of a chain of `layers` layers, and whether the trace is
    whole: one launch of the first pass per layer and call, and every
    pass's launches split evenly over the calls (else the profiler dropped
    some, and no per-launch times are given)."""
    total = sum(ms for _, ms in kernels) / iters
    parts, glue = [], list(kernels)
    even = sum(passes[0][1] in name for name, _ in kernels) \
        == layers * iters
    for label, key in passes:
        mine = [ms for name, ms in kernels if key in name]
        glue = [(name, ms) for name, ms in glue if key not in name]
        if not mine:
            continue
        per_call = len(mine) // iters
        part = (f"{label} {sum(mine) / iters!r} ms "
                f"({sum(mine) / iters / total:.1%}")
        if len(mine) % iters:
            even = False
            parts.append(part + f"; {len(mine)} launches in {iters} calls)")
            continue
        layers = [sum(mine[j::per_call]) / iters for j in range(per_call)]
        parts.append(part + f"; per launch {[round(v, 4) for v in layers]})")
    rest = sum(ms for _, ms in glue) / iters
    parts.append(f"glue {rest!r} ms ({rest / total:.1%}, "
                 f"{len(glue) // iters} kernels)")
    return f"{total!r} ms device per call: " + "; ".join(parts), even


def _pass_split(torch, fn, iters: int, layers: int,
                passes=BWD_PASSES) -> str:
    """Device time per call of a train chain's pass under torch.profiler,
    split by kernel (`passes`, each with its launches in order: the top
    layer first in the backward, `BWD_PASSES`, layer 0 first in the
    forward, `FWD_PASSES`) and the torch glue (every other kernel: row
    sums, the statistics, casts, padding, the dW partials' reduction).
    The profiler now and then drops launches (a whole call's, at times):
    up to three tries for a whole trace of the `layers`-layer chain."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.name, e.self_device_time_total / 1e3) for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0),
            key=lambda e: e.time_range.start)]
        if not kernels:
            continue
        line, even = _split_line(kernels, iters, layers, passes)
        if even:
            return line
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    return line + " (the profiler dropped launches in three tries)"


def phase_times(torch, model, clouds, card) -> dict[str, tuple]:
    """Per kernel and for the forward: CUDA-event time per call over
    back-to-back calls (what a caller pays, host launch time included where
    the host is the slower side) and device time from the profiler."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        point_mlp_max,
        point_mlp_max_plain,
    )
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    rng = np.random.default_rng(SEED + 3)
    _, y, given, count = _inputs(torch, rng, DEVICE, B, N, M)
    wbs = _mlp_weights(torch, rng, DEVICE)
    cases = {
        "fps": (lambda: fps(y, given, count, M),
                lambda: fps_plain(y, given, count, M), 20),
        "point_mlp_max": (lambda: point_mlp_max(y, wbs),
                          lambda: point_mlp_max_plain(y, wbs), 20),
    }
    times = {}
    for name, (kernel_fn, plain_fn, iters) in cases.items():
        times[name] = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        log("times", f"{name} at the main shape: kernel {times[name][0]!r} "
                     f"ms per call, {k_dev!r} ms device; plain "
                     f"{times[name][1]!r} ms per call, {p_dev!r} ms device "
                     f"({card})")
    for label, (b, n, m, full) in FPS_TIMES.items():
        rng = np.random.default_rng(SEED + 6)
        _, pts, gv, cnt = _inputs(torch, rng, DEVICE, b, n, m)
        cnt = torch.full_like(cnt, m if full else 1)
        ms, p_ms = _pair_ms(torch, lambda: fps(pts, gv, cnt, m),
                            lambda: fps_plain(pts, gv, cnt, m), 20)
        dev = _device_ms(torch, lambda: fps(pts, gv, cnt, m), 20)
        log("times", f"fps at the {label} (B={b}, N={n}, k={m}, count "
                     f"{m if full else 1}): kernel {ms!r} ms per call, "
                     f"{dev!r} ms device; plain {p_ms!r} ms per call "
                     f"({card})")
    xc = torch.from_numpy(clouds).to(DEVICE)

    def plain_forward():
        with plain_on_cuda():
            model(xc)

    with torch.inference_mode():
        k, p = _pair_ms(torch, lambda: model(xc), plain_forward, 10)
        k_dev = _device_ms(torch, lambda: model(xc), 10)
        p_dev = _device_ms(torch, plain_forward, 10)
    log("times", f"eval forward + matching, B={B}, {N}->{M}: kernel path "
                 f"{k!r} ms = {B / k * 1e3!r} clouds/s, {k_dev!r} ms device "
                 f"(busy {k_dev / k!r}); plain path {p!r} ms = "
                 f"{B / p * 1e3!r} clouds/s, {p_dev!r} ms device "
                 f"(busy {p_dev / p!r}) ({card})")
    return times


# --------------------------------------------------------- train path phases

def _rel_err(t, ref) -> float:
    """max |t - ref| / max |ref|, in float64."""
    ref = ref.double()
    return float((t.double() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30))


def _norm_err(t, ref) -> float:
    """|t - ref| / |ref| over the whole tensor, in float64."""
    ref = ref.double()
    return float((t.double() - ref).norm() / ref.norm().clamp_min(1e-30))


def _share_off(t, ref, frac=1e-3) -> float:
    """Share of entries further from ref than frac of ref's largest."""
    ref = ref.double()
    return float(((t.double() - ref).abs() > frac * ref.abs().max())
                 .double().mean())


def _outside(a, b, rtol=1e-3, atol=1e-5) -> float:
    """Share of elements of a outside rtol/atol of b."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() > atol + rtol * b.abs()).double().mean())


def _no_worse_than_plain(name, k, p, ref, floor=1e-5) -> tuple[float, float]:
    """The kernel's error against the float64 reference, as a share of the
    reference's largest entry, is at most twice the plain f32 version's,
    or `floor` where both are below that."""
    ek, ep = _rel_err(k, ref), _rel_err(p, ref)
    if not ek <= max(2 * ep, floor):
        raise AssertionError(f"{name}: kernel error {ek!r} of the f64 scale, "
                             f"plain f32 {ep!r}")
    return ek, ep


def _ctx(plain: bool):
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    return plain_on_cuda() if plain else contextlib.nullcontext()


def _exact_inputs(torch, rng, b, n, widths=WIDTHS):
    x = torch.from_numpy(rng.standard_normal((b, n, widths[0]))
                         .astype(np.float32)).to(DEVICE)
    groups = [[], [], [], []]          # weights, biases, gammas, betas
    for cin, cout in zip(widths[:-1], widths[1:]):
        vals = ((rng.standard_normal((cin, cout)) / np.sqrt(cin)),
                0.1 * rng.standard_normal(cout),
                1 + 0.1 * rng.standard_normal(cout),
                0.1 * rng.standard_normal(cout))
        for g, v in zip(groups, vals):
            g.append(torch.from_numpy(v.astype(np.float32)).to(DEVICE))
    g = torch.from_numpy(rng.standard_normal((b, widths[-1]))
                         .astype(np.float32)).to(DEVICE)
    return x, groups, g


def _exact_call(torch, x, groups, g, *, plain=False, dtype=None):
    """(pooled, stats, grads): grads are dx, then dW, d bias, d gamma,
    d beta per layer."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_train_max

    dtype = dtype or x.dtype
    x = x.to(dtype).clone().requires_grad_(True)
    groups = [[t.to(dtype).clone().requires_grad_(True) for t in grp]
              for grp in groups]
    with _ctx(plain):
        pooled, means, vars_ = point_mlp_exact_train_max(x, *groups)
    (pooled * g.to(dtype)).sum().backward()
    torch.cuda.synchronize()
    return (pooled.detach(), [*means, *vars_],
            [x.grad] + [t.grad for grp in groups for t in grp])


def _soft_inputs(torch, rng, b, n, m):
    pts, qs, cot = (torch.from_numpy(rng.standard_normal(shape)
                                     .astype(np.float32)).to(DEVICE)
                    for shape in ((b, n, 3), (b, m, 3), (b, m, 3)))
    return pts, qs, torch.tensor(0.7, device=DEVICE), cot


def _soft_call(torch, pts, qs, sigma, k, cot, *, plain=False):
    from samplenet_tpu_torch.ops.cuda import soft_project

    p, q, s = (t.clone().requires_grad_(True) for t in (pts, qs, sigma))
    with _ctx(plain):
        out, idx = soft_project(p, q, s, k)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), idx, [p.grad, q.grad, s.grad]


def phase_compare_train(torch) -> dict[str, float]:
    """The train kernels against their plain versions; returns max |error|
    at the train step's shapes."""
    rng = np.random.default_rng(SEED + 10)
    errs = {}
    nl = len(WIDTHS) - 1
    for label, (b, n) in (("main", (B, N)), ("ragged", (RAGGED_B, RAGGED_N))):
        x, groups, g = _exact_inputs(torch, rng, b, n)
        pk, sk, gk = _exact_call(torch, x, groups, g)
        pp, sp, gp = _exact_call(torch, x, groups, g, plain=True)
        torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
        for a, c in zip(sk, sp):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
        for grads in (gk, gp):
            if any(t.any() for t in grads[1 + nl:1 + 2 * nl]):
                raise AssertionError("a dense bias got a nonzero gradient")
        _, _, gk2 = _exact_call(torch, x, groups, g)
        if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
            raise AssertionError("point_mlp_exact backward is not "
                                 "deterministic")
        graded = [i for i in range(len(gk)) if not 1 + nl <= i < 1 + 2 * nl]
        if label == "ragged":
            for i in graded:
                torch.testing.assert_close(gk[i], gp[i], rtol=1e-3, atol=1e-5)
            log("compare", f"point_mlp_exact ragged x{tuple(x.shape)}: "
                           f"pooled, means, vars within 1e-4; dx, dW, "
                           f"dgamma, dbeta within rtol 1e-3 / atol 1e-5; "
                           f"dense-bias gradients 0; backward bit-equal "
                           f"across two runs")
            continue
        pr, sr, gr = _exact_call(torch, x, groups, g, plain=True,
                                 dtype=torch.float64)
        fwd_k = max(_rel_err(a, r) for a, r in zip([pk, *sk], [pr, *sr]))
        fwd_p = max(_rel_err(a, r) for a, r in zip([pp, *sp], [pr, *sr]))
        worst = (0.0, 0.0)
        for i in graded:
            ek, ep = _no_worse_than_plain(f"point_mlp_exact grad {i}",
                                          gk[i], gp[i], gr[i])
            worst = max(worst, (ek, ep))
        log("compare", f"point_mlp_exact main x{tuple(x.shape)} widths "
                       f"{WIDTHS}: pooled max |k - p| "
                       f"{float((pk - pp).abs().max())!r}, stats within "
                       f"1e-4; pooled and stats against f64: kernel "
                       f"{fwd_k!r}, plain f32 {fwd_p!r} of scale; "
                       f"gradients against the f64 plain version: "
                       f"worst kernel error {worst[0]!r} of scale (plain "
                       f"f32 {worst[1]!r}); elements outside rtol 1e-3 / "
                       f"atol 1e-5: kernel vs plain "
                       f"{max(_outside(gk[i], gp[i]) for i in graded)!r}"
                       f", plain f32 vs f64 "
                       f"{max(_outside(gp[i], gr[i]) for i in graded)!r}"
                       f"; dense-bias gradients 0; backward bit-equal")
        errs["point_mlp_exact_fwd"] = float((pk - pp).abs().max())
        errs["point_mlp_exact_bwd"] = max(
            float((gk[i] - gp[i]).abs().max()) for i in graded)

    for label, (b, n, m, k) in (
            ("main", SOFT_SHAPES["classification step"]),
            ("ragged", (RAGGED_B, RAGGED_N, RAGGED_M, 16)),
            ("progressive", SOFT_SHAPES["progressive step"]),
            ("progressive AE", SOFT_SHAPES["progressive AE step"]),
            ("N=16384", SOFT_LONG)):
        pts, qs, sigma, cot = _soft_inputs(torch, rng, b, n, m)
        ok, ik, gk = _soft_call(torch, pts, qs, sigma, k, cot)
        op, ip, gp = _soft_call(torch, pts, qs, sigma, k, cot, plain=True)
        if not torch.equal(ik, ip):
            raise AssertionError(f"soft_projection {label}: idx differ in "
                                 f"{int((ik != ip).sum())} places")
        torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
        for a, c in zip(gk, gp):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
        _, _, gk2 = _soft_call(torch, pts, qs, sigma, k, cot)
        if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
            raise AssertionError("soft_projection backward is not "
                                 "deterministic")
        log("compare", f"soft_projection {label} points{tuple(pts.shape)} "
                       f"queries{tuple(qs.shape)} k={k}: idx bit-equal, out "
                       f"max |k - p| {float((ok - op).abs().max())!r} "
                       f"(atol 1e-5), d points / d queries / d sigma^2 "
                       f"within rtol 1e-4 / atol 1e-5, backward bit-equal "
                       f"across two runs")
        if label == "main":
            errs["soft_projection_fwd"] = float((ok - op).abs().max())
            errs["soft_projection_bwd"] = max(
                float((a - c).abs().max()) for a, c in zip(gk, gp))
    return errs


def make_train_setup(torch):
    """The procedural data (B clouds of N points from SEED) and a seeded
    frozen vanilla PointNet(40)."""
    from samplenet_tpu_torch.data import make_dataset
    from samplenet_tpu_torch.models import PointNetClassifier

    data, labels = make_dataset(B, N, seed=SEED)
    classifier = PointNetClassifier(
        NUM_CLASSES, generator=torch.Generator().manual_seed(SEED + 5))
    return data, labels.astype(np.int64), classifier.to(DEVICE)


def _train_step(torch, classifier, *, dtype=None, augment=False):
    """A fresh sampler state from SEED and its train step; with `dtype`
    the sampler and a copy of the classifier run in that dtype."""
    from samplenet_tpu_torch.train.classification import (
        SampleNetConfig,
        create_samplenet_state,
        make_samplenet_train_step,
    )

    scfg = SampleNetConfig(batch_size=B)
    net, state = create_samplenet_state(scfg, device=DEVICE, seed=SEED)
    if dtype is not None:
        net.to(dtype)             # in place: the optimiser keeps its params
        classifier = copy.deepcopy(classifier).to(dtype)
    step = make_samplenet_train_step(net, classifier, scfg,
                                     augment_data=augment)
    return net, state, step


def phase_train_step(torch, data, labels, classifier) -> dict[str, int]:
    """One step on the kernel path and on the plain path from the same
    state, both held against the plain path in float64; then the main
    path: TRAIN_STEPS augmented steps with the launch counters around."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    x = torch.from_numpy(data).to(DEVICE)
    y = torch.from_numpy(labels).to(DEVICE)
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("plain", True, None),
                               ("f64", True, torch.float64)):
        net, state, step = _train_step(torch, classifier, dtype=dtype)
        with _ctx(plain):
            metrics = step(state, x if dtype is None else x.to(dtype), y)
        torch.cuda.synchronize()
        runs[name] = (
            metrics,
            {k: p.grad.detach().clone() for k, p in net.named_parameters()},
            {k: v.detach().clone() for k, v in net.named_buffers()
             if "running_" in k})
        del net, state, step
    (mk, gk, sk), (mp, gp, sp), (_, gr, _) = (runs["kernel"], runs["plain"],
                                             runs["f64"])
    for k in ("loss", "task", "simplification", "projection"):
        if not bool(torch.isfinite(mk[k])):
            raise AssertionError(f"train step {k} is not finite")
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=0)
    scale = max(float(g.abs().max()) for g in gr.values())
    worst = (0.0, 0.0, "")
    for name in gk:
        if name in CANCELLED:
            for g in (gk[name], gp[name]):
                if float(g.abs().max()) > 1e-4 * scale:
                    raise AssertionError(f"{name}: gradient not round-off")
            if name.startswith("conv") and bool(gk[name].any()):
                raise AssertionError(f"{name}: kernel gradient is not 0")
            continue
        ek, ep = _no_worse_than_plain(name, gk[name], gp[name], gr[name])
        worst = max(worst, (ek, ep, name))
    for name in sk:
        torch.testing.assert_close(sk[name], sp[name], rtol=1e-3, atol=1e-5)
    log("train", f"one step at B={B}, {N}->{M}, k={K}, augmentation off: "
                 f"loss {float(mk['loss'])!r} (plain {float(mp['loss'])!r}); "
                 f"task, simplification, projection within rtol 1e-4; "
                 f"gradients against the f64 plain path: worst kernel "
                 f"error {worst[0]!r} of scale at {worst[2]} (plain f32 "
                 f"{worst[1]!r}); BN-cancelled gradients round-off, conv "
                 f"biases 0; new running stats within rtol 1e-3 / atol 1e-5")

    net, state, step = _train_step(torch, classifier, augment=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    reset_launch_counts()
    losses = [step(state, x, y, gen)["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or state.optimizer.count != TRAIN_STEPS:
        raise AssertionError(f"train steps: losses {losses}, applied "
                             f"{state.optimizer.count}")
    missing = [k for k in (*TRAIN_KERNELS, "nn_direction")
               if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the train path launched no {missing}")
    log("train", f"{TRAIN_STEPS} augmented steps on the kernel path: "
                 f"losses {losses}; kernel launches {counts}")
    return counts


def phase_train_cli(torch, classifier) -> None:
    """The train CLI on the card, then resumed from its snapshot."""
    with tempfile.TemporaryDirectory() as tmp:
        cls_path = os.path.join(tmp, "classifier.pth")
        torch.save({k: v.cpu() for k, v in classifier.state_dict().items()},
                   cls_path)
        log_dir = os.path.join(tmp, "log")
        cmd = [sys.executable, "-m", "samplenet_tpu_torch.train.train_samplenet",
               "--device", "cuda", "--dataset", "procedural", "--epochs", "1",
               "--steps-per-epoch", "3", "--train-size", "256",
               "--test-size", "64", "--classifier-weights", cls_path,
               "--log-dir", log_dir, "--seed", str(SEED)]
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        outs = []
        for extra in ([], ["--resume"]):
            t0 = time.monotonic()
            proc = subprocess.run(cmd + extra, cwd=HERE, env=env,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"train CLI {extra} exited "
                                   f"{proc.returncode}:\n"
                                   f"{(proc.stdout + proc.stderr)[-4000:]}")
            outs.append((proc.stdout, time.monotonic() - t0))
        acc = [line.split("eval_acc@32=")[1].split()[0]
               for line in outs[0][0].splitlines() if "eval_acc@32=" in line]
        if len(acc) != 1 or not np.isfinite(float(acc[0])):
            raise AssertionError(f"train CLI logged no eval_acc: {outs[0][0]}")
        for rel in ("snap_last/state.pt", "ckpt/sampler.pth"):
            if not os.path.exists(os.path.join(log_dir, rel)):
                raise AssertionError(f"train CLI wrote no {rel}")
        if "at epoch 1" not in outs[1][0]:
            raise AssertionError(f"--resume did not start at epoch 1: "
                                 f"{outs[1][0]}")
    log("train-cli", f"train_samplenet --device cuda, 1 epoch of 3 steps: "
                     f"exit 0 in {outs[0][1]:.1f} s, eval_acc@32={acc[0]}, "
                     f"snap_last and ckpt written; --resume started at "
                     f"epoch 1 (exit 0 in {outs[1][1]:.1f} s)")


def phase_times_train(torch, data, labels, classifier, card
                      ) -> tuple[dict[str, tuple], int]:
    """The train kernels fwd and bwd and the train step, each against the
    plain versions: CUDA-event time per call and profiler device time; and
    the points the timed backward gathers (its bound's bytes)."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    rng = np.random.default_rng(SEED + 11)
    x, (ws, _, gs, bes), g = _exact_inputs(torch, rng, B, N)
    saved_k = pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5)[3]
    saved_p = pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5)[3]
    pts, qs, sigma, cot = _soft_inputs(torch, rng, B, N, M)
    sigma = sigma.reshape(1)
    idx_k = spk.soft_project_fwd_cuda(pts, qs, sigma, K)[1]
    gathered = _gathered(torch, idx_k, N)
    cases = {
        "point_mlp_exact_fwd": (
            lambda: pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5),
            lambda: pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5), 10),
        "point_mlp_exact_bwd": (
            lambda: pme.point_mlp_exact_bwd_cuda(x, ws, gs, bes, saved_k, g),
            lambda: pme.point_mlp_exact_bwd_plain(x, ws, gs, bes, saved_p, g),
            10),
        "soft_projection_fwd": (
            lambda: spk.soft_project_fwd_cuda(pts, qs, sigma, K),
            lambda: spk.soft_project_fwd_plain(pts, qs, sigma, K), 20),
        "soft_projection_bwd": (
            lambda: spk.soft_project_bwd_cuda(pts, qs, sigma, idx_k, cot),
            lambda: spk.soft_project_bwd_plain(pts, qs, sigma, idx_k, cot),
            20),
    }
    times = {}
    for name, (kernel_fn, plain_fn, iters) in cases.items():
        times[name] = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        log("times", f"{name} at the train shape: kernel {times[name][0]!r} "
                     f"ms per call, {k_dev!r} ms device; plain "
                     f"{times[name][1]!r} ms per call, {p_dev!r} ms device "
                     f"({card})")
    for path, (b, n, m, k) in SOFT_SHAPES.items():
        sp, sq, ss, sc = _soft_inputs(torch, rng, b, n, m)
        ss = ss.reshape(1)
        k_ms, p_ms = _pair_ms(
            torch, lambda: spk.soft_project_fwd_cuda(sp, sq, ss, k),
            lambda: spk.soft_project_fwd_plain(sp, sq, ss, k), 20)
        k_dev = _device_ms(torch, lambda: spk.soft_project_fwd_cuda(
            sp, sq, ss, k), 20)
        bound = _soft_fwd_bound(b, n, m, k)
        log("times", f"soft_projection_fwd at the {path}'s shape (B={b}, "
                     f"N={n}, M={m}, k={k}): kernel {k_ms!r} ms per call, "
                     f"{k_dev!r} ms device; plain {p_ms!r} ms per call; "
                     f"bound {bound[0]!r} ms ({bound[1]}) ({card})")
        si = spk.soft_project_fwd_cuda(sp, sq, ss, k)[1]

        def bwd(sp=sp, sq=sq, ss=ss, si=si, sc=sc):
            return spk.soft_project_bwd_cuda(sp, sq, ss, si, sc)

        def bwd_plain(sp=sp, sq=sq, ss=ss, si=si, sc=sc):
            return spk.soft_project_bwd_plain(sp, sq, ss, si, sc)

        k_ms, p_ms = _pair_ms(torch, bwd, bwd_plain, 10)
        k_dev, p_dev = _device_ms(torch, bwd, 10), _device_ms(torch,
                                                              bwd_plain, 3)
        bound = _soft_bwd_bound(b, n, m, k, _gathered(torch, si, n))
        log("times", f"soft_projection_bwd at the {path}'s shape (B={b}, "
                     f"N={n}, M={m}, k={k}): kernel {k_ms!r} ms per call, "
                     f"{k_dev!r} ms device; plain {p_ms!r} ms per call, "
                     f"{p_dev!r} ms device; bound {bound[0]!r} ms "
                     f"({bound[1]}) ({card})")
        del sp, sq, ss, sc, si
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    split = _pass_split(torch, cases["point_mlp_exact_fwd"][0], 5,
                        len(WIDTHS) - 1, FWD_PASSES)
    log("profile", f"point_mlp_exact_fwd at B={B}, N={N}, widths {WIDTHS}: "
                   f"{split} ({card})")
    split = _pass_split(torch, cases["point_mlp_exact_bwd"][0], 5,
                        len(WIDTHS) - 1)
    log("profile", f"point_mlp_exact_bwd at B={B}, N={N}, widths {WIDTHS}: "
                   f"{split} ({card})")
    del saved_k, saved_p

    xd = torch.from_numpy(data).to(DEVICE)
    yd = torch.from_numpy(labels).to(DEVICE)
    _, kstate, kstep = _train_step(torch, classifier, augment=True)
    _, pstate, pstep = _train_step(torch, classifier, augment=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def kernel_step():
        kstep(kstate, xd, yd, gen)

    def plain_step():
        with plain_on_cuda():
            pstep(pstate, xd, yd, gen)

    k, p = _pair_ms(torch, kernel_step, plain_step, 5)
    k_dev = _device_ms(torch, kernel_step, 3)
    p_dev = _device_ms(torch, plain_step, 3)
    log("times", f"train step, B={B}, {N}->{M}, k={K}, augmented: kernel "
                 f"path {k!r} ms = {B / k * 1e3!r} clouds/s, {k_dev!r} ms "
                 f"device (busy {k_dev / k!r}); plain path {p!r} ms = "
                 f"{B / p * 1e3!r} clouds/s, {p_dev!r} ms device (busy "
                 f"{p_dev / p!r}) ({card})")
    return times, gathered


NN_LIBRARY_SHAPES = ("eval and Chamfer direction 1", "Chamfer direction 2")


def _nn_per_step(dev: dict[str, float]) -> str:
    """The 1-NN kernel's device ms a step of each train path, from the
    device ms a call at each of NN_SHAPES: the classification step's two
    Chamfer directions, the reconstruction sampler's two, the progressive
    classification step's 16 (s over 1024 and back for 8 sizes), the
    progressive AE step's 32 (the AE's Chamfer, 2048 over 2048 both ways,
    and s over 2048 and back, for 8 sizes), the registration PCRNet
    step's 2 (1024 over 1024 both ways) and the registration sampler
    step's 6 (each shape twice: two clouds, or both ways)."""
    paths = {"classification": [], "recon sampler": [],
             "progressive cls": [], "progressive AE": [],
             "registration PCRNet": [], "registration sampler": []}
    for name, ms in dev.items():
        if name.startswith(("registration PCRNet", "registration sampler")):
            paths[name.split(" step")[0]] += [ms] * 2
        elif name in NN_LIBRARY_SHAPES:
            paths["classification"].append(ms)
        elif name.startswith("recon sampler"):
            paths["recon sampler"].append(ms)
        elif name.startswith("progressive cls"):
            # s = 1024: 1024 over 1024 both ways
            paths["progressive cls"] += [ms] * (2 if name.endswith(
                f"{PROG_N} over {PROG_N}") else 1)
        elif name.startswith("progressive AE"):
            # the AE's Chamfer 16 times, and s = 2048 both ways
            paths["progressive AE"] += [ms] * (18 if name.endswith(
                f"{RECON_N} over {RECON_N}") else 1)
    return "; ".join(f"{k} {sum(v)!r} ms device in {len(v)} launches"
                     for k, v in paths.items())


def phase_times_nn(torch, card, costs) -> dict[str, tuple]:
    """The 1-NN kernel at every shape of NN_SHAPES: per call (CUDA events)
    and device time, its plan, its bound and its issue floor (the plan's
    SASS lane-instructions a pair, `costs`, over the card's issue slots),
    the plain version per call alternating with it; at the classification
    step's two Chamfer directions also the plain version's device time
    and the two-call library route, torch.cdist without the
    matmul form, then amin: a yardstick with other rounding, a square root
    and no index, which the port does not call. Returns the kernel's and
    the plain version's ms per call at the eval shape."""
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck

    rng = np.random.default_rng(SEED + 8)
    dev, times = {}, {}
    for name, (b, n1, n2, snap) in NN_SHAPES.items():
        x, y = _randn(torch, rng, b, n1, 3), _randn(torch, rng, b, n2, 3)
        fn = ck.nn_snap if snap else ck.nn_direction

        def kernel(fn=fn, x=x, y=y):
            return fn(x, y)

        plan = ck.kernel_plan(x.device.index, b, n1, n2)
        ms, dev[name] = _time_ms(torch, kernel, 20), _device_ms(torch,
                                                                kernel, 20)
        bound = _nn_bound(b, n1, n2, snap)
        per_pair = costs[(plan.lanes, plan.queries, snap)]
        floor = nn_issue_floor(b, n1, n2, per_pair)
        line = (f"{'nn_snap' if snap else 'nn_direction'} at {name} (B={b}, "
                f"{n1} over {n2}), plan L={plan.lanes} Q={plan.queries} "
                f"warps={plan.warps} chunk={plan.chunk}: kernel {ms!r} ms per "
                f"call, {dev[name]!r} ms device; bound {bound[0]!r} ms "
                f"({bound[1]}); issue floor {floor!r} ms ({per_pair!r} "
                f"lane-instructions a pair)")

        def plain(x=x, y=y, snap=snap):
            return (ck.nn_snap_plain if snap else ck.nn_direction_plain)(x, y)

        k_ms, p_ms = _pair_ms(torch, kernel, plain, 20)
        line += (f"; alternating with the plain version: kernel {k_ms!r} "
                 f"ms per call, plain {p_ms!r} ms per call")
        if name in NN_LIBRARY_SHAPES:
            def library(x=x, y=y):
                return torch.cdist(x, y, compute_mode=(
                    "donot_use_mm_for_euclid_dist")).amin(2)

            if name == "eval and Chamfer direction 1":
                times["nn_direction"] = (k_ms, p_ms)
            line += (f", {_device_ms(torch, plain, 20)!r} ms device; library "
                     f"route (two calls: cdist, amin; other rounding, no "
                     f"index) {_time_ms(torch, library, 20)!r} ms per call, "
                     f"{_device_ms(torch, library, 20)!r} ms device")
        log("times-nn", f"{line} ({card})")
        del x, y
    torch.cuda.empty_cache()
    log("times-nn", f"per train step: {_nn_per_step(dev)} ({card})")
    return times


# ------------------------------------------------- reconstruction track phases

def _randn(torch, rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(DEVICE)


# the EMD kernel skips a warp's pairs where every level * d2 lies below
# this; expf is +0 there (tests/test_torch_port_cuda.py checks it)
EMD_UNDERFLOW = -104.0
EMD_STEEP_LEVELS = (-65536.0, -16384.0, -4096.0, -1024.0, -256.0)


def _straddle_clouds(torch, rng, b, n):
    """xyz2_i at distance sqrt(104 / |L|) * (1 -+ 1e-3) from xyz1_i, L
    cycling over the steep levels: level * d2 just above and just below the
    EMD kernel's underflow threshold, at each of them."""
    x1 = 4.0 * rng.standard_normal((b, n, 3))
    way = rng.standard_normal((b, n, 3))
    way /= np.linalg.norm(way, axis=2, keepdims=True)
    i = np.arange(n)
    level = np.asarray(EMD_STEEP_LEVELS)[i % len(EMD_STEEP_LEVELS)]
    side = np.where((i // len(EMD_STEEP_LEVELS)) % 2 == 0, 1 - 1e-3, 1 + 1e-3)
    x2 = x1 + (np.sqrt(EMD_UNDERFLOW / level) * side)[None, :, None] * way
    return (torch.from_numpy(x1.astype(np.float32)).to(DEVICE),
            torch.from_numpy(x2.astype(np.float32)).to(DEVICE))


def _emd_check(torch, label, x1, x2) -> float:
    """The EMD kernel against its plain version in f32 and f64; returns
    max |kernel - plain| over the cost and both gradients."""
    from samplenet_tpu_torch.ops.cuda import emd_cost, emd_cost_plain
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    ck, g1k, g2k = emd_cost(x1, x2)
    with plain_on_cuda():
        cp, g1p, g2p = emd_cost(x1, x2)
    cr, g1r, g2r = emd_cost_plain(x1.double(), x2.double())
    torch.cuda.synchronize()
    cost_k = float(((ck.double() - cr).abs() / cr.abs()).max())
    cost_p = float(((cp.double() - cr).abs() / cr.abs()).max())
    if not cost_k <= 2e-4:
        raise AssertionError(f"emd {label}: cost {cost_k!r} from f64 "
                             f"(plain f32 {cost_p!r}), above rtol 2e-4")
    grads = []
    for name, k, p, r in (("g1", g1k, g1p, g1r), ("g2", g2k, g2p, g2r)):
        ek, ep = _rel_err(k, r), _rel_err(p, r)
        nk, np_ = _norm_err(k, r), _norm_err(p, r)
        if not (ek <= max(1.5 * ep, 5e-4) and nk <= max(1.5 * np_, 5e-4)):
            raise AssertionError(f"emd {label} {name}: kernel error {ek!r} "
                                 f"of the f64 scale, {nk!r} of its norm; "
                                 f"plain f32 {ep!r}, {np_!r}")
        grads.append(f"{name} max {ek!r} / norm {nk!r} / share off "
                     f"{_share_off(k, r)!r} (plain {ep!r} / {np_!r} / "
                     f"{_share_off(p, r)!r})")
    c0, z1, z2 = emd_cost(x1, x2, with_grads=False)
    again = emd_cost(x1, x2)
    torch.cuda.synchronize()
    if not (torch.equal(c0, ck) and not z1.any() and not z2.any()):
        raise AssertionError(f"emd {label}: without gradients the cost "
                             f"differs or the gradients are not 0")
    if not all(torch.equal(a, c) for a, c in zip(again, (ck, g1k, g2k))):
        raise AssertionError(f"emd {label}: two runs differ")
    log("compare", f"emd {label} xyz1{tuple(x1.shape)} xyz2{tuple(x2.shape)}:"
                   f" cost rel err against f64 {cost_k!r} (plain f32 "
                   f"{cost_p!r}, rtol 2e-4); gradients against f64, max "
                   f"error as a share of the largest entry / norm-wise "
                   f"error / share of entries off by more than 1e-3 of the "
                   f"largest: {', '.join(grads)} (max and norm-wise: "
                   f"kernel <= 1.5x plain or 5e-4); cost bit-equal without "
                   f"gradients, gradients then 0; bit-equal across two runs")
    return max(float((a - c).abs().max())
               for a, c in ((ck, cp), (g1k, g1p), (g2k, g2p)))


def phase_compare_recon(torch) -> dict[str, float]:
    """The EMD kernel at the track's shape and at ragged ones, and the
    exact-BN chain at the track's widths, against their plain versions."""
    rng = np.random.default_rng(SEED + 20)
    errs = {}
    for label, (b, n, m) in (("main", (RECON_B, RECON_N, RECON_N)),
                             ("ragged", (3, 96, 160)),
                             ("n=2m", (3, 128, 64)),
                             ("2048x64", (3, 2048, 64))):
        err = _emd_check(torch, label, _randn(torch, rng, b, n, 3),
                         _randn(torch, rng, b, m, 3))
        if label == "main":
            errs["emd"] = err
        torch.cuda.empty_cache()
    # the card test's straddling input (test_emd_matches_plain_and_f64):
    # on some draws of this construction the plain f32 version itself lands
    # 5.6e-4 from f64 in the cost (PERF.md, PR 8)
    straddle = _straddle_clouds(torch, np.random.default_rng(20640), 2, 320)
    _emd_check(torch, "straddling the skip threshold", *straddle)
    x, groups, g = _exact_inputs(torch, rng, RECON_B, RECON_N, RECON_WIDTHS)
    nl = len(RECON_WIDTHS) - 1
    pk, sk, gk = _exact_call(torch, x, groups, g)
    pp, sp, gp = _exact_call(torch, x, groups, g, plain=True)
    pr, sr, gr = _exact_call(torch, x, groups, g, plain=True,
                             dtype=torch.float64)
    fwd_k = max(_rel_err(a, r) for a, r in zip([pk, *sk], [pr, *sr]))
    fwd_p = max(_rel_err(a, r) for a, r in zip([pp, *sp], [pr, *sr]))
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    for a, c in zip(sk, sp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    worst = (0.0, 0.0)
    for i in range(len(gk)):
        if 1 + nl <= i < 1 + 2 * nl:
            if gk[i].any() or gp[i].any():
                raise AssertionError("a dense bias got a nonzero gradient")
            continue
        # floor 1e-4: at B*N = 102400 both f32 paths land about 1e-6 to
        # 1e-4 of scale from f64, either one ahead per tensor (PERF.md)
        worst = max(worst, _no_worse_than_plain(
            f"point_mlp_exact (recon widths) grad {i}", gk[i], gp[i], gr[i],
            floor=1e-4))
    _, _, gk2 = _exact_call(torch, x, groups, g)
    if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
        raise AssertionError("point_mlp_exact backward (recon widths) is "
                             "not deterministic")
    log("compare", f"point_mlp_exact x{tuple(x.shape)} widths {RECON_WIDTHS}"
                   f" (128->256, 256->128 whole): pooled max |k - p| "
                   f"{float((pk - pp).abs().max())!r}, stats within 1e-4; "
                   f"pooled and stats against f64: kernel {fwd_k!r}, plain "
                   f"f32 {fwd_p!r} of scale; "
                   f"gradients against the f64 plain version: worst kernel "
                   f"error {worst[0]!r} of scale (plain f32 {worst[1]!r}); "
                   f"dense-bias gradients 0; backward bit-equal")
    del x, groups, g, pk, pp, pr, gk, gp, gr, gk2
    torch.cuda.empty_cache()
    _compare_recon_shapes(torch, rng)
    return errs


def _compare_recon_shapes(torch, rng) -> None:
    """point_mlp_max, fps, nn_direction and soft_projection through their
    own wrappers at the shapes the reconstruction path gives them, each
    against its plain version, with the tolerances of the serving and
    classification phases."""
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        nn_direction_plain,
        point_mlp_max,
        point_mlp_max_plain,
    )

    b, n, m, k = RECON_B, RECON_N, RECON_M, RECON_K
    q, pts, given, count = _inputs(torch, rng, DEVICE, b, n, m)
    wbs = _mlp_weights(torch, rng, DEVICE, RECON_WIDTHS)
    pk, pp = point_mlp_max(pts, wbs), point_mlp_max_plain(pts, wbs)
    torch.cuda.synchronize()
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    log("compare", f"point_mlp_max x{tuple(pts.shape)} widths {RECON_WIDTHS}"
                   f" (the AE encoder and the sampler at eval): max |kernel "
                   f"- plain| {float((pk - pp).abs().max())!r} (rtol = atol "
                   f"= 1e-4); {_f64_reading(torch, pts, wbs, pk, pp)}")
    ik, xk = fps(pts, given, count, m)
    ip, xp = fps_plain(pts, given, count, m)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(xk, xp)):
        raise AssertionError(f"fps {n}->{m}: kernel != plain "
                             f"({int((ik != ip).sum())} idx differ)")
    log("compare", f"fps points{tuple(pts.shape)} k={m} (matching completion "
                   f"and the FPS baseline), count {int(count.min())}.."
                   f"{int(count.max())}: idx and xyz bit-equal")
    for a, c in ((q, pts), (pts, q)):
        dk, ik = nn_direction(a, c)
        dp, ip = nn_direction_plain(a, c)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
            raise AssertionError(
                f"nn_direction {a.shape[1]}->{c.shape[1]}: kernel != plain "
                f"({int((ik != ip).sum())} idx differ)")
    log("compare", f"nn_direction {m}->{n} and {n}->{m} at B={b} (the "
                   f"simplification loss, matching): dist and idx bit-equal")
    pts, qs, sigma, cot = _soft_inputs(torch, rng, b, n, m)
    ok, ik, gk = _soft_call(torch, pts, qs, sigma, k, cot)
    op, ip, gp = _soft_call(torch, pts, qs, sigma, k, cot, plain=True)
    if not torch.equal(ik, ip):
        raise AssertionError(f"soft_projection (recon): idx differ in "
                             f"{int((ik != ip).sum())} places")
    torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
    for a, c in zip(gk, gp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
    log("compare", f"soft_projection points{tuple(pts.shape)} queries"
                   f"{tuple(qs.shape)} k={k}: idx bit-equal, out max |k - p| "
                   f"{float((ok - op).abs().max())!r} (atol 1e-5), d points "
                   f"/ d queries / d sigma^2 within rtol 1e-4 / atol 1e-5")


def _recon_state(torch, which, ae=None, *, dtype=None):
    """A seeded AE (which="ae") or reconstruction sampler and its train
    step; with `dtype` the model (and a copy of the AE) runs in it."""
    from samplenet_tpu_torch.train import reconstruction as rec

    if which == "ae":
        cfg = rec.AEConfig(loss="emd", batch_size=RECON_B)
        model, state = rec.create_ae_state(cfg, device=DEVICE, seed=SEED)
        if dtype is not None:
            model.to(dtype)
        return model, state, rec.make_ae_train_step(model, cfg)
    cfg = rec.SampleNetAEConfig(batch_size=RECON_B)
    model, state = rec.create_sampler_ae_state(cfg, device=DEVICE,
                                               seed=SEED + 1)
    if dtype is not None:
        model.to(dtype)
        ae = copy.deepcopy(ae).to(dtype)
    return model, state, rec.make_sampler_ae_train_step(model, ae, cfg,
                                                         "emd")


def _recon_step_check(torch, which, x, ae=None) -> str:
    """One step on the kernel path, the plain path and the plain path in
    f64 from the same seeded state."""
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("plain", True, None),
                               ("f64", True, torch.float64)):
        model, state, step = _recon_state(torch, which, ae, dtype=dtype)
        with _ctx(plain):
            out = step(state, x if dtype is None else x.to(dtype))
        torch.cuda.synchronize()
        metrics = out if isinstance(out, dict) else {"loss": out}
        runs[name] = (metrics, {k: p.grad.detach().clone()
                                for k, p in model.named_parameters()
                                if p.grad is not None})
        del model, state, step
    (mk, gk), (mp, gp), (_, gr) = runs["kernel"], runs["plain"], runs["f64"]
    for k in mk:
        if not bool(torch.isfinite(mk[k])):
            raise AssertionError(f"{which} step: {k} is not finite")
        torch.testing.assert_close(mk[k], mp[k], rtol=2e-4, atol=0)
    worst = (0.0, 0.0, "")
    for name, ref in gr.items():
        if not ref.any():       # conv biases before BN: 0 on every path
            if gk[name].any() or gp[name].any():
                raise AssertionError(f"{which} {name}: gradient not 0")
            continue
        ek, ep = _norm_err(gk[name], ref), _norm_err(gp[name], ref)
        if not ek <= max(2 * ep, 1e-4):
            raise AssertionError(f"{which} {name}: kernel error {ek!r} of "
                                 f"the f64 norm, plain f32 {ep!r}")
        worst = max(worst, (ek, ep, name))
    torch.cuda.empty_cache()
    return (f"{which} step: " + ", ".join(
        f"{k} {float(v)!r} (plain {float(mp[k])!r})" for k, v in mk.items())
        + f"; gradients' norm-wise error against f64: worst kernel "
          f"{worst[0]!r} at {worst[2]} (plain f32 {worst[1]!r})")


def _recon_eval_check(torch, data, x, ae) -> str:
    """The SampleNet and FPS-baseline eval steps, and evaluate_nre over
    both, on the kernel path and the plain path: per-cloud losses and NRE
    within rtol 1e-4 (point_mlp_max's f32 sums run in another order)."""
    from samplenet_tpu_torch.train import reconstruction as rec

    sampler, state, _ = _recon_state(torch, "sampler", ae)
    parts = []
    for name, step in (
            ("samplenet", rec.make_sampler_ae_eval_step(sampler, ae)),
            ("fps", rec.make_fps_ae_eval_step(ae, RECON_M))):
        runs = []
        for plain in (False, True):
            with _ctx(plain):
                losses = step(state, x)
                nre = rec.evaluate_nre(step, state, data, RECON_B,
                                       device=DEVICE)
            torch.cuda.synchronize()
            runs.append((losses, nre))
        (lk, nk), (lp, np_) = runs
        for a, c in zip(lk, lp):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=0)
        for key in nk:
            if not abs(nk[key] - np_[key]) <= 1e-4 * abs(np_[key]):
                raise AssertionError(f"{name} eval: {key} {nk[key]!r} on "
                                     f"the kernel path, {np_[key]!r} plain")
        diff = max(float(((a - c) / c).abs().max()) for a, c in zip(lk, lp))
        parts.append(f"{name}: per-cloud losses max rel diff {diff!r}, NRE "
                     f"{nk['nre']!r} (plain {np_['nre']!r})")
    return ("eval steps and evaluate_nre, kernel path vs plain path "
            "(rtol 1e-4): " + "; ".join(parts))


def make_recon_data(torch):
    from samplenet_tpu_torch.data import make_dataset

    data, _ = make_dataset(RECON_B, RECON_N, seed=SEED)
    return data, torch.from_numpy(data).to(DEVICE)


def phase_recon_train(torch, data, x) -> dict[str, int]:
    """Kernel vs plain vs f64 for one step of each phase; then the track's
    main path with the launch counters around it."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import reconstruction as rec

    log("recon", _recon_step_check(torch, "ae", x))
    ae, _, _ = _recon_state(torch, "ae")
    log("recon", _recon_step_check(torch, "sampler", x, ae=ae))
    log("recon", _recon_eval_check(torch, data, x, ae))

    reset_launch_counts()
    ae, ae_state, ae_step = _recon_state(torch, "ae")
    ae_losses = [ae_step(ae_state, x) for _ in range(RECON_STEPS)]
    sampler, s_state, s_step = _recon_state(torch, "sampler", ae)
    s_metrics = [s_step(s_state, x) for _ in range(RECON_STEPS)]
    nre = rec.evaluate_nre(rec.make_sampler_ae_eval_step(sampler, ae),
                           s_state, data, RECON_B, device=DEVICE)
    fps = rec.evaluate_nre(rec.make_fps_ae_eval_step(ae, RECON_M), s_state,
                           data, RECON_B, device=DEVICE)
    torch.cuda.synchronize()
    counts = launch_counts()
    ae_losses = [float(v) for v in ae_losses]
    s_losses = [float(m["loss"]) for m in s_metrics]
    values = ae_losses + s_losses + [nre["nre"], fps["nre"],
                                     nre["loss_full_mean"]]
    if not all(np.isfinite(values)) or ae_state.optimizer.count != RECON_STEPS \
            or s_state.optimizer.count != RECON_STEPS:
        raise AssertionError(f"recon path: AE losses {ae_losses}, sampler "
                             f"losses {s_losses}, NRE {nre}, FPS {fps}")
    missing = [k for k in RECON_PATH if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the reconstruction path launched no {missing}")
    log("recon", f"{RECON_STEPS} AE steps (EMD) at B={RECON_B}, "
                 f"{RECON_N} points: losses {ae_losses}; {RECON_STEPS} "
                 f"sampler steps against it (m={RECON_M}, k={RECON_K}): "
                 f"losses {s_losses}; NRE {nre['nre']!r}, FPS-baseline NRE "
                 f"{fps['nre']!r}; kernel launches {counts}")
    return counts


def phase_recon_cli(torch) -> None:
    """Both phases of the reconstruction CLI on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m",
            "samplenet_tpu_torch.train.train_reconstruction", "--device",
            "cuda", "--epochs", "1", "--steps-per-epoch", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        ae_dir, sn_dir = os.path.join(tmp, "ae"), os.path.join(tmp, "sn")
        runs = [("ae", ["--phase", "ae", "--loss", "emd", "--log-dir",
                        ae_dir]),
                ("samplenet", ["--phase", "samplenet", "--ae-ckpt",
                               os.path.join(ae_dir, "ckpt"), "--fps-baseline",
                               "--log-dir", sn_dir]),
                ("progressive", ["--phase", "samplenet", "--ae-ckpt",
                                 os.path.join(ae_dir, "ckpt"),
                                 "--progressive", "--num-out-points",
                                 str(RECON_N), "--test-size", "50",
                                 "--log-dir", os.path.join(tmp, "prog")])]
        outs = {}
        for name, extra in runs:
            t0 = time.monotonic()
            proc = subprocess.run(base + extra, cwd=HERE, env=env,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"train_reconstruction --phase {name} "
                                   f"exited {proc.returncode}:\n"
                                   f"{(proc.stdout + proc.stderr)[-4000:]}")
            outs[name] = (proc.stdout, time.monotonic() - t0)
        for rel in ("ae/ckpt/ae.pth", "ae/ckpt/config.json",
                    "sn/ckpt/sampler.pth", "prog/ckpt/sampler.pth",
                    "prog/prefix_nre.json"):
            if not os.path.exists(os.path.join(tmp, rel)):
                raise AssertionError(f"the reconstruction CLI wrote no {rel}")
        with open(os.path.join(tmp, "prog", "prefix_nre.json")) as f:
            curve = {int(k): v["nre"] for k, v in json.load(f).items()}
    ae_line = [ln for ln in outs["ae"][0].splitlines() if "epoch 0:" in ln]
    sn_lines = [ln for ln in outs["samplenet"][0].splitlines()
                if "| NRE=" in ln or "FPS baseline" in ln]
    if len(ae_line) != 1 or len(sn_lines) != 2 or "nan" in " ".join(
            ae_line + sn_lines):
        raise AssertionError(f"the reconstruction CLI logged: "
                             f"{outs['ae'][0]}\n{outs['samplenet'][0]}")
    if sorted(curve) != [16 * 2 ** i for i in range(8)] or not all(
            np.isfinite(list(curve.values()))):
        raise AssertionError(f"--progressive wrote the curve {curve}:\n"
                             f"{outs['progressive'][0]}")
    log("recon-cli", f"--phase ae --loss emd: exit 0 in "
                     f"{outs['ae'][1]:.1f} s, {ae_line[0].split('] ')[-1]}; "
                     f"--phase samplenet --fps-baseline: exit 0 in "
                     f"{outs['samplenet'][1]:.1f} s, "
                     + "; ".join(ln.split("] ")[-1] for ln in sn_lines)
                     + f"; --phase samplenet --progressive --num-out-points "
                       f"{RECON_N}: exit 0 in {outs['progressive'][1]:.1f} s,"
                       f" prefix NRE {curve}")


def phase_times_recon(torch, x, card) -> dict[str, tuple]:
    """On one line: the EMD kernel (on randn clouds and on the AE step's own
    pair) and the exact-BN chain at the track's shapes, and both train
    steps, each against the plain path."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda.emd_kernel import (
        emd_cost_cuda,
        emd_cost_plain,
    )
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    rng = np.random.default_rng(SEED + 21)
    x1 = _randn(torch, rng, RECON_B, RECON_N, 3)
    x2 = _randn(torch, rng, RECON_B, RECON_N, 3)
    ae = _recon_state(torch, "ae")[0]
    with torch.no_grad():      # the AE step's own pair at its seeded start
        recon = ae(x, training=True).contiguous()
    del ae
    parts, times = [], {}
    cases = {"emd": (lambda: emd_cost_cuda(x1, x2, True),
                     lambda: emd_cost_plain(x1, x2, True), 3),
             "emd (the AE step's pair)": (
                 lambda: emd_cost_cuda(recon, x, True),
                 lambda: emd_cost_plain(recon, x, True), 3)}
    xe, (ws, _, gs, bes), g = _exact_inputs(torch, rng, RECON_B, RECON_N,
                                            RECON_WIDTHS)
    saved_k = pme.point_mlp_exact_fwd_cuda(xe, ws, gs, bes, 1e-5)[3]
    saved_p = pme.point_mlp_exact_fwd_plain(xe, ws, gs, bes, 1e-5)[3]
    cases["point_mlp_exact_fwd (recon widths)"] = (
        lambda: pme.point_mlp_exact_fwd_cuda(xe, ws, gs, bes, 1e-5),
        lambda: pme.point_mlp_exact_fwd_plain(xe, ws, gs, bes, 1e-5), 10)
    cases["point_mlp_exact_bwd (recon widths)"] = (
        lambda: pme.point_mlp_exact_bwd_cuda(xe, ws, gs, bes, saved_k, g),
        lambda: pme.point_mlp_exact_bwd_plain(xe, ws, gs, bes, saved_p, g),
        10)
    exact_fwd, exact_bwd = _exact_bounds(RECON_B, RECON_N, RECON_WIDTHS)
    bounds = [_emd_bound(RECON_B, RECON_N, RECON_N)] * 2 + [exact_fwd,
                                                            exact_bwd]
    for (name, (kernel_fn, plain_fn, iters)), bound in zip(cases.items(),
                                                           bounds):
        k, p = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        times[name] = (k, p)
        parts.append(f"{name}: kernel {k!r} ms per call, {k_dev!r} ms "
                     f"device; plain {p!r} ms, {p_dev!r} ms device; bound "
                     f"{bound[0]!r} ms ({bound[1]})")
    split = _pass_split(torch, cases["point_mlp_exact_fwd (recon widths)"][0],
                        5, len(RECON_WIDTHS) - 1, FWD_PASSES)
    log("profile", f"point_mlp_exact_fwd at B={RECON_B}, N={RECON_N}, widths "
                   f"{RECON_WIDTHS}: {split} ({card})")
    split = _pass_split(torch, cases["point_mlp_exact_bwd (recon widths)"][0],
                        5, len(RECON_WIDTHS) - 1)
    log("profile", f"point_mlp_exact_bwd at B={RECON_B}, N={RECON_N}, widths "
                   f"{RECON_WIDTHS}: {split} ({card})")
    del saved_k, saved_p
    torch.cuda.empty_cache()
    steps = {}
    for which in ("ae", "sampler"):
        ae = None if which == "ae" else _recon_state(torch, "ae")[0]
        _, kstate, kstep = _recon_state(torch, which, ae)
        _, pstate, pstep = _recon_state(torch, which, ae)

        def kernel_step(kstep=kstep, kstate=kstate):
            kstep(kstate, x)

        def plain_step(pstep=pstep, pstate=pstate):
            with plain_on_cuda():
                pstep(pstate, x)

        k, p = _pair_ms(torch, kernel_step, plain_step, 3)
        k_dev = _device_ms(torch, kernel_step, 3)
        p_dev = _device_ms(torch, plain_step, 3)
        steps[which] = (k, p)
        log("profile", f"{which} train step, kernel path: "
                       f"{_profile_top(torch, kernel_step, 3)} ({card})")
        parts.append(
            f"{which} train step, B={RECON_B}, {RECON_N} points, EMD: kernel "
            f"path {k!r} ms = {RECON_B / k * 1e3!r} clouds/s, {k_dev!r} ms "
            f"device (busy {k_dev / k!r}); plain path {p!r} ms = "
            f"{RECON_B / p * 1e3!r} clouds/s, {p_dev!r} ms device (busy "
            f"{p_dev / p!r})")
        torch.cuda.empty_cache()
    log("times-recon", " | ".join(parts) + f" ({card})")
    return {"emd": times["emd"]}


# ------------------------------------------------------ progressive phases

def _ghost_call(torch, x, groups, g, bb, bf16, *, plain=False, dtype=None):
    """(outputs, grads) of point_mlp_train_max: outputs are pooled, then
    the means and vars; grads are dx, then dW, d bias, d gamma, d beta per
    layer."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_max

    dtype = dtype or x.dtype
    x = x.to(dtype).clone().requires_grad_(True)
    groups = [[t.to(dtype).clone().requires_grad_(True) for t in grp]
              for grp in groups]
    with _ctx(plain):
        pooled, means, vars_ = point_mlp_train_max(x, *groups, block_b=bb,
                                                   bf16=bf16)
    (pooled * g.to(dtype)).sum().backward()
    torch.cuda.synchronize()
    return ([pooled.detach(), *means, *vars_],
            [x.grad] + [t.grad for grp in groups for t in grp])


def _out_gap(torch, x, groups, g, bb, bf16, ref_outs) -> float:
    """Worst norm-wise distance of the ghost kernel's outputs (pooled and
    statistics) from the plain bf16 version's on the same block."""
    outs, _ = _ghost_call(torch, x, groups, g, bb, bf16)
    return max(_norm_err(a, r) for a, r in zip(outs, ref_outs))


def _bwd_gap(torch, x, groups, g, bb, bf16) -> float:
    """Worst norm-wise distance of the backward kernel's gradients from the
    plain bf16 VJP run on the kernel forward's own state (its stored xhat
    and argmax), so that only sums taken in other orders part the two."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt

    weights, _, gammas, betas = groups
    _, _, _, saved = pmt.point_mlp_train_fwd_cuda(x, weights, gammas, betas,
                                                  1e-5, bb, bf16)
    kernel = pmt.point_mlp_train_bwd_cuda(x, weights, gammas, betas, 1e-5,
                                          bb, bf16, saved, g)
    zs, mus, rstds, argmax = saved
    p = x.shape[0] // bb
    xhats = [((z.view(p, -1, z.shape[-1]) - mu[:, None]) * rstd[:, None])
             .to(torch.bfloat16).float() for z, mu, rstd in zip(zs, mus, rstds)]
    plain = pmt.point_mlp_train_vjp_plain(x, weights, gammas, betas, 1e-5,
                                          bb, True, xhats, argmax.long(), g)
    torch.cuda.synchronize()
    flat = lambda gr: [gr[0], *gr[1], *gr[2], *gr[3]]  # noqa: E731
    return max(_norm_err(a, r) for a, r in zip(flat(kernel), flat(plain)))


def phase_compare_progressive(torch) -> dict[str, float]:
    """nn_snap bit for bit, and the ghost chain forward and backward against
    the plain version in float64 with bf16 off (the function both paths
    round), at the progressive step's shape in bf16 and f32 and at a
    ragged one; returns max |kernel - plain| at the main shape (bf16)."""
    from samplenet_tpu_torch.ops.cuda import auto_block_b, nn_snap, nn_snap_plain

    rng = np.random.default_rng(SEED + 30)
    errs = {}
    for label, (b, n1, n2) in (("main", (PROG_B, PROG_N, PROG_N)),
                               ("ragged", (3, 1000, 2500))):
        x, y = _randn(torch, rng, b, n1, 3), _randn(torch, rng, b, n2, 3)
        dk, ik, sk = nn_snap(x, y)
        dp, ip, sp = nn_snap_plain(x, y)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dp) and torch.equal(ik, ip)
                and torch.equal(sk, sp)):
            raise AssertionError(
                f"nn_snap {label}: kernel != plain ({int((ik != ip).sum())} "
                f"idx differ, max |snapped| diff "
                f"{float((sk - sp).abs().max())})")
        if not torch.equal(sk, torch.gather(
                y, 1, ik.long()[..., None].expand(-1, -1, 3))):
            raise AssertionError(f"nn_snap {label}: snapped != y[idx]")
        log("compare", f"nn_snap {label} x{tuple(x.shape)} y{tuple(y.shape)}: "
                       f"dist, idx and snapped bit-equal; snapped == y[idx]")
        if label == "main":
            errs["nn_snap"] = float((sk - sp).abs().max())
    nl = len(WIDTHS) - 1
    for label, b, n, bf16 in (("main bf16", PROG_B, PROG_N, True),
                              ("main f32", PROG_B, PROG_N, False),
                              ("ragged bf16", 3, 1000, True)):
        bb = auto_block_b(b, n, WIDTHS[1:], bf16) if b == PROG_B else 1
        x, groups, g = _exact_inputs(torch, rng, b, n)
        ok, gk = _ghost_call(torch, x, groups, g, bb, bf16)
        op, gp = _ghost_call(torch, x, groups, g, bb, bf16, plain=True)
        orf, gr = _ghost_call(torch, x, groups, g, bb, False, plain=True,
                              dtype=torch.float64)
        worst = {"largest entry": (0.0, 0.0), "norm-wise": (0.0, 0.0)}
        bias = range(len(ok) + 1 + nl, len(ok) + 1 + 2 * nl)
        for i, (a, c, r) in enumerate(zip(ok + gk, op + gp, orf + gr)):
            if i in bias:
                if a.any() or c.any():
                    raise AssertionError("a dense bias got a nonzero "
                                         "gradient")
                continue
            for kind, err in (("largest entry", _rel_err),
                              ("norm-wise", _norm_err)):
                ek, ep = err(a, r), err(c, r)
                if not ek <= max(2 * ep, 1e-4):
                    raise AssertionError(
                        f"point_mlp_train {label} output/grad {i}: kernel "
                        f"error {ek!r} ({kind}) against f64, plain {ep!r}")
                worst[kind] = max(worst[kind], (ek, ep))
        _, gk2 = _ghost_call(torch, x, groups, g, bb, bf16)
        if not all(torch.equal(a, c) for a, c in zip(gk, gk2)):
            raise AssertionError(f"point_mlp_train {label}: the backward is "
                                 f"not deterministic")
        graded = [i for i in range(len(gk)) if i + len(ok) not in bias]
        rounding = ""
        if bf16:
            # the rule above lets a kernel that rounds nothing (or the
            # wrong values) pass; this check, with its control, does not
            gap = (_out_gap(torch, x, groups, g, bb, True, op),
                   _bwd_gap(torch, x, groups, g, bb, True))
            ctl = (_out_gap(torch, x, groups, g, bb, False, op),
                   _bwd_gap(torch, x, groups, g, bb, False))
            if not (gap[0] <= GHOST_BF16_OUT and gap[1] <= GHOST_BF16_BWD):
                raise AssertionError(
                    f"point_mlp_train {label}: against the plain bf16 "
                    f"version, norm-wise {gap!r}, limits {GHOST_BF16_OUT}, "
                    f"{GHOST_BF16_BWD}")
            if not (ctl[0] > GHOST_BF16_OUT and ctl[1] > GHOST_BF16_BWD):
                raise AssertionError(
                    f"point_mlp_train {label}: the control (kernel with "
                    f"bf16 off) passes the bf16 check: {ctl!r}")
            rounding = (f"; against the plain bf16 version, worst norm-wise "
                        f"outputs {gap[0]!r}, backward on the kernel's "
                        f"forward state {gap[1]!r} (limits {GHOST_BF16_OUT}, "
                        f"{GHOST_BF16_BWD}); the control, bf16 off: "
                        f"{ctl[0]!r}, {ctl[1]!r}")
        log("compare", f"point_mlp_train {label} x{tuple(x.shape)} widths "
                       f"{WIDTHS} block_b={bb}: against the f64 plain "
                       f"version with bf16 off, worst (kernel, plain) error "
                       f"of scale over pooled, stats and gradients: "
                       + "; ".join(f"{k} {v[0]!r}, {v[1]!r}"
                                   for k, v in worst.items())
                       + f"; max |kernel - plain|: pooled "
                       f"{float((ok[0] - op[0]).abs().max())!r}; dense-bias "
                       f"gradients 0; backward bit-equal across two runs"
                       + rounding)
        if label == "main bf16":
            errs["point_mlp_train_fwd"] = float((ok[0] - op[0]).abs().max())
            errs["point_mlp_train_bwd"] = max(
                float((gk[i] - gp[i]).abs().max()) for i in graded)
        del x, groups, ok, gk, op, gp, orf, gr, gk2
        torch.cuda.empty_cache()
    return errs


def _prog_step(torch, classifier, *, ghost=False, dtype=None):
    """A fresh progressive sampler from SEED (exact or ghost chain) and its
    train step; with `dtype` the sampler and a copy of the classifier run
    in that dtype."""
    from samplenet_tpu_torch.train import progressive as prog

    cfg = prog.ProgressiveConfig(batch_size=PROG_B,
                                 fused_train=True if ghost else None)
    net, state = prog.create_progressive_state(cfg, device=DEVICE, seed=SEED)
    if dtype is not None:
        net.to(dtype)
        classifier = copy.deepcopy(classifier).to(dtype)
    return net, state, prog.make_progressive_train_step(net, classifier, cfg)


@contextlib.contextmanager
def _ghost_without_rounding(torch):
    """Within the block, the ghost chain runs with bf16 off at the block
    size that bf16 gives: the function that the bf16 paths round."""
    from samplenet_tpu_torch.nn import layers
    from samplenet_tpu_torch.ops.cuda import auto_block_b

    real = layers.point_mlp_train_max

    def unrounded(x, weights, *rest, eps, bf16, blocks=None):
        bb = auto_block_b(x.shape[0], x.shape[1], tuple(
            w.shape[1] for w in weights), bf16) if blocks is None \
            else blocks.block_b
        return real(x, weights, *rest, eps=eps, bf16=False, block_b=bb,
                    blocks=blocks)

    layers.point_mlp_train_max = unrounded
    try:
        yield
    finally:
        layers.point_mlp_train_max = real


def phase_progressive_step(torch, x, y, classifier) -> None:
    """One progressive classification step per chain (exact; ghost in
    bf16) on the kernel path and the plain path from the same state, both
    held against the plain path in float64 (for the ghost chain with bf16
    off at the same block size). On the ghost chain the kernel step's
    gradients are also held to the plain bf16 step's, norm-wise, a check
    that the kernel step with bf16 off (the control) must fail."""
    for chain in ("exact", "ghost"):
        runs = {}
        variants = [("kernel", False, None), ("plain", True, None),
                    ("f64", True, torch.float64)]
        if chain == "ghost":
            variants.append(("unrounded", False, None))
        for name, plain, dtype in variants:
            net, state, step = _prog_step(torch, classifier,
                                          ghost=chain == "ghost", dtype=dtype)
            unround = _ghost_without_rounding(torch) \
                if chain == "ghost" and name in ("f64", "unrounded") \
                else contextlib.nullcontext()
            with _ctx(plain), unround:
                metrics = step(state, x if dtype is None else x.to(dtype), y)
            torch.cuda.synchronize()
            runs[name] = (
                metrics,
                {k: p.grad.detach().clone() for k, p in net.named_parameters()},
                {k: v.detach().clone() for k, v in net.named_buffers()
                 if "running_" in k})
            del net, state, step
        (mk, gk, sk), (mp, gp, sp), (mr, gr, sr) = (
            runs["kernel"], runs["plain"], runs["f64"])
        for k in mk:
            if not bool(torch.isfinite(mk[k])):
                raise AssertionError(f"progressive step ({chain}) {k} is not "
                                     f"finite")
            if chain == "exact":
                torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=1e-6)
            elif k.startswith("acc@"):
                # bf16 roundings the two paths sum in other orders can flip
                # a near-tie argmax: at most two clouds of the batch
                if abs(float(mk[k]) - float(mp[k])) > 2.0 / PROG_B + 1e-6:
                    raise AssertionError(f"progressive step (ghost) {k}: "
                                         f"kernel {float(mk[k])!r}, plain "
                                         f"{float(mp[k])!r}")
            else:
                ref = abs(float(mr[k]))
                ek = abs(float(mk[k]) - float(mr[k])) / max(ref, 1e-30)
                ep = abs(float(mp[k]) - float(mr[k])) / max(ref, 1e-30)
                if not ek <= max(2 * ep, 1e-2):
                    raise AssertionError(
                        f"progressive step (ghost) {k}: kernel error {ek!r} "
                        f"against f64 unrounded, plain bf16 {ep!r}")
        scale = max(float(g.abs().max()) for g in gr.values())
        worst = (0.0, 0.0, "")
        for name in gk:
            if name in CANCELLED:
                for g in (gk[name], gp[name]):
                    if float(g.abs().max()) > 1e-4 * scale:
                        raise AssertionError(f"{chain} {name}: gradient not "
                                             f"round-off")
                if name.startswith("conv") and bool(gk[name].any()):
                    raise AssertionError(f"{chain} {name}: kernel gradient "
                                         f"is not 0")
                continue
            for err in (_rel_err, _norm_err):
                ek, ep = err(gk[name], gr[name]), err(gp[name], gr[name])
                if not ek <= max(2 * ep, 1e-4):
                    raise AssertionError(
                        f"progressive step ({chain}) {name}: kernel error "
                        f"{ek!r} ({err.__name__}) against f64, plain {ep!r}")
                worst = max(worst, (ek, ep, name))
        rounding = ""
        if chain == "ghost":
            gu = runs.pop("unrounded")[1]
            graded = [k for k in gk if k not in CANCELLED]
            gap = max(_norm_err(gk[k], gp[k]) for k in graded)
            ctl = max(_norm_err(gu[k], gp[k]) for k in graded)
            if not gap <= GHOST_BF16_STEP < ctl:
                raise AssertionError(
                    f"progressive step (ghost): gradients vs the plain bf16 "
                    f"step, norm-wise: kernel {gap!r}, control (bf16 off) "
                    f"{ctl!r}, limit {GHOST_BF16_STEP}")
            rounding = (f" gradients against the plain bf16 step: worst "
                        f"norm-wise {gap!r} (limit {GHOST_BF16_STEP}; the "
                        f"control, bf16 off, {ctl!r});")
            del gu
        for name in sk:
            ek, ep = _norm_err(sk[name], sr[name]), _norm_err(sp[name],
                                                              sr[name])
            if not ek <= max(2 * ep, 1e-5):
                raise AssertionError(f"progressive step ({chain}) {name}: "
                                     f"kernel {ek!r}, plain {ep!r}")
        log("progressive", f"one step, {chain} chain, B={PROG_B}, {PROG_N} "
                           f"points, sizes 8..{PROG_MAX}: loss "
                           f"{float(mk['loss'])!r} (plain "
                           f"{float(mp['loss'])!r}, f64 {float(mr['loss'])!r});"
                           + (" metrics within rtol 1e-4 of the plain path;"
                              if chain == "exact" else
                              " loss terms within 2x the plain bf16 path's "
                              "error against f64 (or 1e-2), accuracies "
                              "within two clouds;" + rounding)
                           + f" gradients against "
                           f"f64: worst kernel error {worst[0]!r} of scale at "
                           f"{worst[2]} (plain f32 {worst[1]!r}); "
                           f"BN-cancelled gradients round-off, conv biases 0; "
                           f"running stats no worse than plain against f64")
        torch.cuda.empty_cache()


def phase_progressive_path(torch, x, y, data, labels, classifier
                           ) -> dict[str, int]:
    """The progressive track's main path with the launch counters around
    it: PROG_STEPS steps on each chain, one infer step and
    evaluate_prefixes; the infer step's hard and matched outputs are then
    held against the plain path on the same simplified cloud."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds
    from samplenet_tpu_torch.train import progressive as prog

    reset_launch_counts()
    losses = {}
    for chain in ("exact", "ghost"):
        net, state, step = _prog_step(torch, classifier,
                                      ghost=chain == "ghost")
        losses[chain] = [step(state, x, y)["loss"] for _ in range(PROG_STEPS)]
    infer = prog.make_progressive_infer_step(net, PROG_MAX)
    simp, soft, hard, matched = infer(state, x)
    sizes = prog.ProgressiveConfig().sizes
    accs = prog.evaluate_prefixes(infer, state, classifier, data, labels,
                                  sizes, PROG_B, device=DEVICE)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = {k: [float(v) for v in vs] for k, vs in losses.items()}
    if not all(np.isfinite(v).all() for v in losses.values()) \
            or state.optimizer.count != PROG_STEPS:
        raise AssertionError(f"progressive steps: losses {losses}")
    missing = [k for k in PROG_PATH if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the progressive path launched no {missing}: "
                             f"{counts}")
    shape = (PROG_B, PROG_MAX, 3)
    if any(t.shape != shape for t in (simp, soft, hard, matched)) \
            or sorted(accs) != list(sizes) \
            or not all(0.0 <= a <= 1.0 for a in accs.values()):
        raise AssertionError(f"infer step shapes or prefix accuracies: "
                             f"{accs}")
    with plain_on_cuda(), torch.inference_mode():
        hard_p, _, _ = net.project.project(x, simp, hard=True)
        matched_p, _ = nn_match_from_clouds(x, simp, PROG_MAX)
    if not (torch.equal(hard, hard_p) and torch.equal(matched, matched_p)):
        raise AssertionError("infer step: hard or matched differ from the "
                             "plain path")
    uniq = min(len(torch.unique(matched[b], dim=0)) for b in range(PROG_B))
    if uniq != PROG_MAX:
        raise AssertionError(f"matched points not unique: {uniq}")
    log("progressive", f"{PROG_STEPS} steps per chain (exact, ghost bf16) at "
                       f"B={PROG_B}: losses {losses}; infer step ordered "
                       f"outputs [{PROG_B}, {PROG_MAX}, 3], hard and matched "
                       f"bit-equal to the plain path, matched unique; "
                       f"evaluate_prefixes over {len(data)} clouds: "
                       + " ".join(f"acc@{s}={a!r}" for s, a in accs.items())
                       + f"; kernel launches {counts}")
    return counts


def phase_progressive_ae(torch, data, x) -> None:
    """One progressive AE step (B=50, 2048 points, sizes 16..2048, k=16)
    on the kernel path, the plain path and the plain path in float64 from
    the same state, a nonzero gradient for every sampler conv layer, and
    evaluate_ae_prefix_nre on the kernel and the plain path; the kernel
    path's step must launch both soft-projection kernels."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import progressive as prog
    from samplenet_tpu_torch.train import reconstruction as rec

    ae, _, _ = _recon_state(torch, "ae")
    pcfg = prog.ProgressiveAEConfig(batch_size=RECON_B)
    scfg = rec.SampleNetAEConfig(num_out_points=pcfg.max_num_out_points,
                                 batch_size=RECON_B)
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("plain", True, None),
                               ("f64", True, torch.float64)):
        sampler, state = rec.create_sampler_ae_state(scfg, device=DEVICE,
                                                     seed=SEED + 1)
        net_ae = ae if dtype is None else copy.deepcopy(ae).to(dtype)
        if dtype is not None:
            sampler.to(dtype)
        step = prog.make_progressive_ae_train_step(sampler, net_ae, pcfg)
        reset_launch_counts()
        with _ctx(plain):
            metrics = step(state, x if dtype is None else x.to(dtype))
        torch.cuda.synchronize()
        runs[name] = (metrics, {k: p.grad.detach().clone()
                                for k, p in sampler.named_parameters()})
        if name == "kernel":
            keep = (sampler, state)
            counts = launch_counts()
        del sampler, state, step, net_ae
        torch.cuda.empty_cache()
    (mk, gk), (mp, gp), (_, gr) = runs["kernel"], runs["plain"], runs["f64"]
    soft = {k: counts.get(k, 0) for k in ("soft_projection_fwd",
                                          "soft_projection_bwd")}
    if not all(soft.values()):
        raise AssertionError(f"progressive AE step: a soft-projection kernel "
                             f"did not launch: {soft}")
    for k in mk:
        if not bool(torch.isfinite(mk[k])):
            raise AssertionError(f"progressive AE step: {k} is not finite")
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=0)
    dead = [i for i in range(1, 6) if not bool(gk[f"conv{i}.weight"].any())]
    if dead:
        raise AssertionError(f"progressive AE step: no gradient reached conv "
                             f"{dead} of the sampler")
    worst = (0.0, 0.0, "")
    for name, ref in gr.items():
        if not ref.any():
            if gk[name].any() or gp[name].any():
                raise AssertionError(f"progressive AE {name}: gradient not 0")
            continue
        ek, ep = _norm_err(gk[name], ref), _norm_err(gp[name], ref)
        if not ek <= max(2 * ep, 1e-4):
            raise AssertionError(f"progressive AE {name}: kernel error {ek!r}"
                                 f" of the f64 norm, plain f32 {ep!r}")
        worst = max(worst, (ek, ep, name))
    sampler, state = keep
    curves = []
    for plain in (False, True):
        with _ctx(plain):
            curves.append(prog.evaluate_ae_prefix_nre(
                sampler, state, ae, data, pcfg.sizes, RECON_B, device=DEVICE))
    torch.cuda.synchronize()
    for s in pcfg.sizes:
        for key in ("loss_sampled", "loss_full", "nre"):
            a, c = curves[0][s][key], curves[1][s][key]
            if not abs(a - c) <= 1e-4 * abs(c):
                raise AssertionError(f"prefix NRE {s} {key}: kernel {a!r}, "
                                     f"plain {c!r}")
    log("progressive-ae", f"one step at B={RECON_B}, {RECON_N} points, sizes "
                          f"{pcfg.sizes[0]}..{pcfg.sizes[-1]}: "
                          + ", ".join(f"{k} {float(v)!r} (plain "
                                      f"{float(mp[k])!r})"
                                      for k, v in mk.items())
                          + f"; launches {soft}"
                          + f"; gradients' norm-wise error against f64: worst"
                          f" kernel {worst[0]!r} at {worst[2]} (plain f32 "
                          f"{worst[1]!r}); every sampler conv gradient "
                          f"nonzero; prefix NRE kernel vs plain within rtol "
                          f"1e-4: " + " ".join(
                              f"{s}:{curves[0][s]['nre']!r}"
                              for s in pcfg.sizes))
    del keep, sampler, state
    torch.cuda.empty_cache()


def phase_progressive_cli(torch, classifier) -> None:
    """train_progressive on the card with --fused-train, 1 epoch of 2
    steps at the reference configuration (sizes 8..1024)."""
    with tempfile.TemporaryDirectory() as tmp:
        cls_path = os.path.join(tmp, "classifier.pth")
        torch.save({k: v.cpu() for k, v in classifier.state_dict().items()},
                   cls_path)
        log_dir = os.path.join(tmp, "log")
        cmd = [sys.executable, "-m",
               "samplenet_tpu_torch.train.train_progressive", "--device",
               "cuda", "--fused-train", "--epochs", "1", "--steps-per-epoch",
               "2", "--max-num-out-points", str(PROG_MAX), "--train-size",
               "128", "--test-size", "64", "--classifier-weights", cls_path,
               "--log-dir", log_dir, "--seed", str(SEED)]
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=600)
        seconds = time.monotonic() - t0
        if proc.returncode:
            raise RuntimeError(f"train_progressive exited {proc.returncode}:"
                               f"\n{(proc.stdout + proc.stderr)[-4000:]}")
        accs = [ln.split("final ")[-1] for ln in proc.stdout.splitlines()
                if "final eval_acc@" in ln]
        if len(accs) != 8 or not os.path.exists(
                os.path.join(log_dir, "ckpt", "sampler.pth")):
            raise AssertionError(f"train_progressive logged:\n{proc.stdout}")
    log("progressive-cli", f"train_progressive --device cuda --fused-train, "
                           f"1 epoch of 2 steps: exit 0 in {seconds:.1f} s, "
                           f"{' '.join(accs)}, ckpt written")


# ------------------------------------------- classifier and evaluation phases

def _cls_state(torch, cfg, device):
    """The T-net classifier from SEED + 6, made on the CPU with its T-nets'
    transform kernels moved off zero (so every T-net layer gets a
    gradient), then moved to `device`; and its train state."""
    from samplenet_tpu_torch.train.classification import (
        create_classifier_state,
    )

    model, state = create_classifier_state(cfg, device="cpu", seed=SEED + 6)
    gen = torch.Generator().manual_seed(SEED + 8)
    with torch.no_grad():
        for tnet in (model.tnet_input, model.tnet_feature):
            w = tnet.transform.weight
            w.copy_(0.002 * torch.randn(w.shape, generator=gen))
    model.to(device)              # in place: the optimiser keeps its params
    return model, state


def _cli(args: list[str], what: str) -> tuple[str, float]:
    """A port CLI in its own process from the checkout: (stdout, s)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{what} exited {proc.returncode}:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    return proc.stdout, time.monotonic() - t0


def phase_classifier(torch, data, labels, tmp: str) -> None:
    """The T-net PointNetClassifier at its published widths (40 classes,
    B=32, N=1024): forward on the card against the CPU, one train step on
    the card against the CPU in f32 and in float64, then the classifier
    CLI with --use-tnets --bn-schedule and train_samplenet on its
    checkpoint; the checkpoints stay in `tmp` for the evaluate phase."""
    from samplenet_tpu_torch.train.classification import (
        ClassifierConfig,
        make_classifier_train_step,
    )

    x = torch.from_numpy(data[:CLS_B])
    y = torch.from_numpy(labels[:CLS_B])
    cfg = ClassifierConfig(num_classes=NUM_CLASSES, batch_size=CLS_B,
                           use_tnets=True, augment=False)
    card, _ = _cls_state(torch, cfg, DEVICE)
    cpu, _ = _cls_state(torch, cfg, "cpu")
    with torch.inference_mode():
        lk, ek = card(x.to(DEVICE))
        lc, ec = cpu(x)
    scale = float(lc.abs().max())
    torch.testing.assert_close(lk.cpu(), lc, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(ek["transform"].cpu(), ec["transform"],
                               rtol=1e-4, atol=1e-5)
    log("classifier", f"T-net PointNetClassifier({NUM_CLASSES}) forward at "
                      f"B={CLS_B}, N={N}: card vs CPU logits max |d| "
                      f"{float((lk.cpu() - lc).abs().max())!r} of scale "
                      f"{scale!r} (rtol 1e-4, atol 1e-5 of scale); "
                      f"feature transform within 1e-4")

    runs = {}
    for name, dev, dtype in (("card", DEVICE, None), ("cpu", "cpu", None),
                             ("f64", "cpu", torch.float64)):
        model, state = _cls_state(torch, cfg, dev)
        model.dropout_rate = 0.0
        if dtype is not None:
            model.to(dtype)
        step = make_classifier_train_step(model, cfg)
        xd = x.to(dev) if dtype is None else x.to(dev, dtype)
        loss, _ = step(state, xd, y.to(dev))
        runs[name] = (float(loss), {k: p.grad.detach().cpu().double()
                                    for k, p in model.named_parameters()})
    (loss_k, gk), (loss_c, gc), (loss_r, gr) = (runs["card"], runs["cpu"],
                                                runs["f64"])
    if not np.isfinite(loss_k) or abs(loss_k - loss_r) > 1e-4 * abs(loss_r):
        raise AssertionError(f"train step loss {loss_k!r} on the card, "
                             f"{loss_r!r} in f64")
    scale = max(float(g.abs().max()) for g in gr.values())
    # zero in exact arithmetic (dense biases before a BN, and a pooled
    # chain's last BN beta where every cloud's max is positive): f64 reads
    # round-off there, and f32 must too
    cancelled = {k for k, g in gr.items()
                 if float(g.abs().max()) <= 1e-10 * scale}
    worst, bad = (0.0, 0.0, ""), []
    for name in gr:
        if name in cancelled:
            if float(gk[name].abs().max()) > 1e-4 * scale:
                bad.append(f"{name}: gradient not round-off")
            continue
        ek, ec_ = _norm_err(gk[name], gr[name]), _norm_err(gc[name],
                                                           gr[name])
        worst = max(worst, (ek, ec_, name))
        if not (ek <= CLS_GRAD_CAP and ek <= max(2 * ec_, CLS_GRAD_FLOOR)):
            bad.append(f"{name}: card {ek!r}, CPU f32 {ec_!r}")
    log("classifier", f"one train step (dropout 0, augmentation off): loss "
                      f"card {loss_k!r}, CPU f32 {loss_c!r}, f64 {loss_r!r}; "
                      f"gradients norm-wise against f64: worst card "
                      f"{worst[0]!r} at {worst[2]} (CPU f32 {worst[1]!r}); "
                      f"{len(cancelled)} gradients zero in f64 round-off "
                      f"(below 1e-4 of scale)")
    if bad:
        raise AssertionError("classifier step gradients: " + "; ".join(bad))
    tcfg = ClassifierConfig(num_classes=NUM_CLASSES, batch_size=CLS_B,
                            use_tnets=True)
    model, state = _cls_state(torch, tcfg, DEVICE)
    step = make_classifier_train_step(model, tcfg)
    gens = [torch.Generator(device=DEVICE).manual_seed(SEED + i)
            for i in (0, 1)]
    xd, yd = x.to(DEVICE), y.to(DEVICE)
    for _ in range(3):
        step(state, xd, yd, *gens)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = [step(state, xd, yd, *gens)[0] for _ in range(CLS_TIMED)]
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / CLS_TIMED * 1e3
    if not all(np.isfinite([float(v) for v in losses])):
        raise AssertionError(f"classifier steps: losses {losses}")
    log("classifier", f"train step with dropout 0.3 and augmentation, "
                      f"B={CLS_B}: {ms:.3f} ms a step on the host clock "
                      f"(mean of {CLS_TIMED} after 3 warm-up steps)")

    cls_dir, sn_dir = os.path.join(tmp, "cls"), os.path.join(tmp, "sn")
    small = ["--train-size", "128", "--test-size", "64", "--seed", str(SEED)]
    out, s_cls = _cli(["samplenet_tpu_torch.train.train_classifier",
                       "--device", "cuda", "--use-tnets", "--bn-schedule",
                       "--epochs", "1", "--steps-per-epoch", "3",
                       "--log-dir", cls_dir, *small], "train_classifier")
    for d in ("ckpt", "ckpt_last"):
        with open(os.path.join(cls_dir, d, "config.json")) as f:
            config = json.load(f)
        if config.get("use_tnets") is not True or not os.path.exists(
                os.path.join(cls_dir, d, "classifier.pth")):
            raise AssertionError(f"train_classifier wrote {d}: {config}")
    acc = [ln.split("test_acc=")[1] for ln in out.splitlines()
           if "test_acc=" in ln]
    out, s_sn = _cli(["samplenet_tpu_torch.train.train_samplenet",
                      "--device", "cuda", "--epochs", "1",
                      "--steps-per-epoch", "2", "--classifier-ckpt",
                      os.path.join(cls_dir, "ckpt"), "--log-dir", sn_dir,
                      *small], "train_samplenet --classifier-ckpt")
    sn_acc = [ln.split("eval_acc@32=")[1].split()[0]
              for ln in out.splitlines() if "eval_acc@32=" in ln]
    if len(acc) != 1 or len(sn_acc) != 1 or not os.path.exists(
            os.path.join(sn_dir, "ckpt", "sampler.pth")):
        raise AssertionError(f"CLIs logged {acc}, {sn_acc}")
    log("classifier", f"train_classifier --device cuda --use-tnets "
                      f"--bn-schedule, 1 epoch of 3 steps: exit 0 in "
                      f"{s_cls:.1f} s, test_acc={acc[0]}, ckpt and ckpt_last "
                      f"with use_tnets true; train_samplenet "
                      f"--classifier-ckpt on it, 1 epoch of 2 steps: exit 0 "
                      f"in {s_sn:.1f} s, eval_acc@32={sn_acc[0]}")


def _top2_gap(match):
    """[B, m]: (best - second) / best transport weight over the full-cloud
    axis of match [B, N, m]."""
    top2 = match.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) / top2[:, 0].clamp_min(1e-30)


def phase_evaluate(torch, model, data, labels, tmp: str) -> dict[str, int]:
    """The evaluation protocols at the serving shape (B=1024 clouds of 1024
    points, m=32, bottleneck 128) against the T-net classifier of the
    classifier phase's seed: the counted main path on the kernel path,
    then each held against the plain path on the card; then evaluate_cli
    on the classifier phase's checkpoints."""
    from samplenet_tpu_torch.models import SampleNet
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.fps import gather_point
    from samplenet_tpu_torch.ops.matching import (
        approx_match,
        nn_match_from_clouds,
    )
    from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_snap
    from samplenet_tpu_torch.train import checkpoints, evaluate_cli
    from samplenet_tpu_torch.train import evaluate as ev
    from samplenet_tpu_torch.train.classification import ClassifierConfig

    classifier, _ = _cls_state(torch, ClassifierConfig(
        num_classes=NUM_CLASSES, use_tnets=True), DEVICE)
    prog = SampleNet(num_out_points=PROG_MAX, bottleneck_size=128,
                     group_size=K, sigma_mode="tf",
                     generator=torch.Generator().manual_seed(SEED + 7)
                     ).to(DEVICE)
    sizes = [2 ** i for i in range(3, PROG_MAX.bit_length())]   # 8..1024
    pd, pl = data[:2 * PROG_B], labels[:2 * PROG_B]

    secs: dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        secs[name] = time.monotonic() - t0
        return out

    def matched_and_baselines():
        out = {m: timed(m, ev.evaluate_samplenet_matched, model, classifier,
                        data, labels, B, matching=m, device=DEVICE)
               for m in ("nn", "emd")}
        out.update({s: timed(s, ev.evaluate_baseline_sampler, classifier,
                             data, labels, B, M, sampler=s, seed=SEED,
                             device=DEVICE) for s in ("fps", "random")})
        return out

    # warm-up: the first call of each path loads the kernels and cuBLAS
    ev.evaluate_samplenet_matched(model, classifier, data[:64], labels[:64],
                                  64, device=DEVICE)
    reset_launch_counts()
    rk = matched_and_baselines()
    rk["voting"] = timed("voting", ev.evaluate_classifier_voting, classifier,
                         data[:256], labels[:256], 256, 12, device=DEVICE)
    rk["infer"] = timed("infer", ev.infer_ordered, prog, pd, pl,
                        num_out_points=PROG_MAX, batch_size=PROG_B,
                        device=DEVICE)
    rk["prefix"] = timed("prefix", ev.evaluate_prefix_accuracy, classifier,
                         rk["infer"][0]["sampled"], rk["infer"][1], sizes,
                         PROG_B, device=DEVICE)
    torch.cuda.synchronize()
    counts = launch_counts()
    log("evaluate", "seconds a call on the kernel path (host clock, after "
                    "a warm-up call): " + ", ".join(
                        f"{k} {v:.4f}" for k, v in secs.items()))
    missing = [k for k in EVAL_PATH if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the evaluation path launched no {missing}: "
                             f"{counts}")
    with plain_on_cuda():
        rp = matched_and_baselines()
    x = torch.from_numpy(data).to(DEVICE)
    with torch.inference_mode():
        simp_k = model.simplify(x)
        with plain_on_cuda():
            simp_p = model.simplify(x)
            matched_k, _ = nn_match_from_clouds(x, simp_k, M)

    for m in ("nn", "emd"):
        a, b = rk[m], rp[m]
        same = (a["sampled"] == b["sampled"]).all(axis=(1, 2))
        if m == "nn":
            # the matcher on the kernel path's simplified cloud, plain
            if not np.array_equal(a["sampled"], matched_k.cpu().numpy()):
                raise AssertionError("nn matching: kernel path != plain "
                                     "matcher on the same simplified cloud")
            if not same.all():
                raise AssertionError(f"nn matching: {int((~same).sum())} "
                                     f"clouds' matched points differ")
        else:
            with torch.inference_mode():
                mk, mp = approx_match(x, simp_k), approx_match(x, simp_p)
            ik, ip = mk.argmax(1), mp.argmax(1)
            gap = torch.minimum(_top2_gap(mk), _top2_gap(mp))
            close = int((gap <= 1e-6).sum())
            flips = ik != ip
            # the two paths' weights at the kernel path's pick
            wk, wp = mk.gather(1, ik[:, None])[:, 0], mp.gather(
                1, ik[:, None])[:, 0]
            drift = float(((wk - wp).abs() / wk.clamp_min(1e-30)).max())
            worst = float(gap[flips].max()) if bool(flips.any()) else 0.0
            log("evaluate", f"emd matching: {close} of {B * M} transport "
                            f"argmaxes within 1e-6 of their second best, "
                            f"{int((gap <= 1e-3).sum())} within 1e-3; "
                            f"{int(flips.sum())} indices differ between the "
                            f"paths, the largest gap among them {worst!r}; "
                            f"the paths' weights at the kernel path's pick "
                            f"differ by up to {drift!r} relative")
            for r, i in ((a, ik), (b, ip)):
                if not np.array_equal(r["sampled"],
                                      gather_point(x, i).cpu().numpy()):
                    raise AssertionError("emd matching: sampled points are "
                                         "not the transport argmax's")
            if int(flips.sum()) > EMD_FLIP_SHARE * B * M:
                raise AssertionError(f"emd matching: {int(flips.sum())} "
                                     f"indices differ between the paths")
        if not (a["correct"][same] == b["correct"][same]).all() \
                or not (a["unique_nn"] == b["unique_nn"]).all():
            raise AssertionError(f"{m}: correct or unique NN differ")
        np.testing.assert_allclose(a["nll"][same], b["nll"][same], rtol=1e-4)
        if same.all() and (a["accuracy"], a["mean_unique_nn"]) != (
                b["accuracy"], b["mean_unique_nn"]):
            raise AssertionError(f"{m}: accuracy or mean unique NN differ")
        log("evaluate", f"evaluate_samplenet_matched, {m} matching, B={B}: "
                        f"accuracy {a['accuracy']!r} (plain "
                        f"{b['accuracy']!r}), loss {a['loss']!r}, mean "
                        f"unique NN {a['mean_unique_nn']!r} (plain "
                        f"{b['mean_unique_nn']!r}); matched points equal in "
                        f"{int(same.sum())} of {B} clouds, per-cloud NLL "
                        f"within rtol 1e-4 there")
    for s in ("fps", "random"):
        a, b = rk[s], rp[s]
        if not (np.array_equal(a["sampled"], b["sampled"])
                and a["accuracy"] == b["accuracy"]):
            raise AssertionError(f"{s} baseline: kernel path != plain path")
    log("evaluate", f"baselines at m={M}: fps accuracy "
                    f"{rk['fps']['accuracy']!r}, random "
                    f"{rk['random']['accuracy']!r}; points and accuracies "
                    f"equal on the plain path")
    vote = rk["voting"]
    if not (0.0 <= vote["accuracy"] <= 1.0
            and vote["per_class_accuracy"].shape == (NUM_CLASSES,)):
        raise AssertionError(f"voting report: {vote}")
    outs, kept = rk["infer"]
    xs = torch.from_numpy(pd[:PROG_B]).to(DEVICE)
    simp = torch.from_numpy(outs["simplified"][:PROG_B]).to(DEVICE)
    with plain_on_cuda(), torch.inference_mode():
        _, _, hard_p = nn_snap(simp, xs)
        matched_p, _ = nn_match_from_clouds(xs, simp, PROG_MAX)
    if not (np.array_equal(outs["hard_projected"][:PROG_B],
                           hard_p.cpu().numpy())
            and np.array_equal(outs["sampled"][:PROG_B],
                               matched_p.cpu().numpy())) \
            or any(v.shape != (len(pd), PROG_MAX, 3) for v in outs.values()) \
            or not all(np.isfinite(v).all() for v in outs.values()) \
            or sorted(rk["prefix"]) != sizes:
        raise AssertionError("infer_ordered / evaluate_prefix_accuracy")
    log("evaluate", f"evaluate_classifier_voting, 12 votes on 256 clouds: "
                    f"accuracy {vote['accuracy']!r}; infer_ordered of the "
                    f"progressive sampler ({len(pd)} clouds, {PROG_MAX} "
                    f"points): hard and sampled equal the plain snap and "
                    f"matcher on its simplified cloud; prefix accuracies "
                    + " ".join(f"@{s}={a!r}" for s, a in
                               rk["prefix"].items())
                    + f"; kernel launches {counts}")

    cls_ckpt = os.path.join(tmp, "cls", "ckpt")
    prog_ckpt = os.path.join(tmp, "prog", "ckpt")
    checkpoints.save_published(prog_ckpt, prog.state_dict(),
                               {"max_num_out_points": PROG_MAX,
                                "group_size": K})
    common = ["--device", "cuda", "--test-size", "64", "--seed", str(SEED),
              "--log-dir", os.path.join(tmp, "eval")]

    def cli(*argv):               # its log lines stay in --log-dir
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluate_cli.main([*argv, *common])

    t0 = time.monotonic()
    ran = {"classifier": cli("classifier", "--ckpt", cls_ckpt)["accuracy"]}
    for matching in ("nn", "emd"):
        ran[f"samplenet {matching}"] = cli(
            "samplenet", "--ckpt", os.path.join(tmp, "sn", "ckpt"),
            "--classifier-ckpt", cls_ckpt, "--matching", matching)["accuracy"]
    for s in ("fps", "random"):
        ran[f"baseline {s}"] = cli("baseline", "--sampler", s,
                                   "--classifier-ckpt", cls_ckpt)["accuracy"]
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    if have_h5py:
        paths = cli("infer", "--ckpt", prog_ckpt, "--out-dir",
                    os.path.join(tmp, "dumps"))
        ran["from-files"] = cli("from-files", "--dump", paths["sampled"],
                                "--classifier-ckpt", cls_ckpt, "--sizes",
                                "8", "32", "1024")
    if not all(0.0 <= a <= 1.0 for k, a in ran.items() if k != "from-files"):
        raise AssertionError(f"evaluate_cli: {ran}")
    log("evaluate", f"evaluate_cli --device cuda on the classifier phase's "
                    f"checkpoints ({time.monotonic() - t0:.1f} s): "
                    + ", ".join(f"{k} {v!r}" for k, v in ran.items()))
    log("evaluate", "h5py imports: infer and from-files ran" if have_h5py
        else "h5py does not import: infer and from-files did not run")
    return counts


def _ghost_bounds(b: int, n: int, widths, bf16: bool) -> tuple[tuple, tuple]:
    """Bounds of the ghost chain's forward and backward (and of the exact
    chain's in bf16, the same work a point): `_exact_bounds`'s bytes, the
    multiply-adds (2 FLOP forward; 4 backward, dW and dh) at the BF16
    tensor-core peak in bf16 and at FP32 in f32, and BN, ReLU and the
    statistics per channel at FP32."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = sum(a * c for a, c in pairs)
    params = sum(a * c + 4 * c for a, c in pairs)
    chans = sum(widths[1:])
    p, f = b * n, 4
    rate = BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S
    return (_bound(f * (p * widths[0] + params + b * widths[-1] + 2 * chans),
                   (p * 2.0 * macs, rate),
                   (p * 7.0 * chans, FP32_FLOP_PER_S)),
            _bound(f * (2 * p * widths[0] + 2 * params + b * widths[-1]),
                   (p * 4.0 * macs, rate),
                   (p * 12.0 * chans, FP32_FLOP_PER_S)))


def phase_times_progressive(torch, x, y, recon_x, classifier, card
                            ) -> dict[str, tuple]:
    """nn_snap and the ghost chain (bf16) at the progressive step's shape,
    both progressive classification steps, the infer step and the
    progressive AE step, each against the plain path: CUDA-event time per
    call and profiler device time."""
    from samplenet_tpu_torch.ops.cuda import auto_block_b
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda
    from samplenet_tpu_torch.train import progressive as prog
    from samplenet_tpu_torch.train import reconstruction as rec

    rng = np.random.default_rng(SEED + 31)
    q, pts = (_randn(torch, rng, PROG_B, PROG_N, 3) for _ in range(2))
    xg, (ws, _, gs, bes), g = _exact_inputs(torch, rng, PROG_B, PROG_N)
    bb = auto_block_b(PROG_B, PROG_N, WIDTHS[1:], True)
    saved = pmt.point_mlp_train_fwd_cuda(xg, ws, gs, bes, 1e-5, bb, True)[3]
    cases = {
        "nn_snap": (lambda: ck.nn_snap(q, pts),
                    lambda: ck.nn_snap_plain(q, pts), 50),
        "point_mlp_train_fwd": (
            lambda: pmt.point_mlp_train_fwd_cuda(xg, ws, gs, bes, 1e-5, bb,
                                                 True),
            lambda: pmt.point_mlp_train_fwd_plain(xg, ws, gs, bes, 1e-5, bb,
                                                  True), 20),
        "point_mlp_train_bwd": (
            lambda: pmt.point_mlp_train_bwd_cuda(xg, ws, gs, bes, 1e-5, bb,
                                                 True, saved, g),
            lambda: pmt.point_mlp_train_bwd_plain(xg, ws, gs, bes, 1e-5, bb,
                                                  True, g), 20),
    }
    times, parts = {}, []
    for name, (kernel_fn, plain_fn, iters) in cases.items():
        times[name] = _pair_ms(torch, kernel_fn, plain_fn, iters)
        k_dev = _device_ms(torch, kernel_fn, iters)
        p_dev = _device_ms(torch, plain_fn, iters)
        parts.append(f"{name}: kernel {times[name][0]!r} ms per call, "
                     f"{k_dev!r} ms device; plain {times[name][1]!r} ms, "
                     f"{p_dev!r} ms device")
    del saved
    for chain in ("exact", "ghost"):
        _, kstate, kstep = _prog_step(torch, classifier,
                                      ghost=chain == "ghost")
        _, pstate, pstep = _prog_step(torch, classifier,
                                      ghost=chain == "ghost")

        def kernel_step(kstep=kstep, kstate=kstate):
            kstep(kstate, x, y)

        def plain_step(pstep=pstep, pstate=pstate):
            with plain_on_cuda():
                pstep(pstate, x, y)

        k, p = _pair_ms(torch, kernel_step, plain_step, 3)
        k_dev = _device_ms(torch, kernel_step, 3)
        p_dev = _device_ms(torch, plain_step, 3)
        if chain == "ghost":
            log("profile", f"progressive step (ghost), kernel path: "
                           f"{_profile_top(torch, kernel_step, 3)} ({card})")
        parts.append(f"progressive step ({chain} chain), B={PROG_B}, "
                     f"{PROG_N} points, sizes 8..{PROG_MAX}: kernel path "
                     f"{k!r} ms = {PROG_B / k * 1e3!r} clouds/s, {k_dev!r} "
                     f"ms device (busy {k_dev / k!r}); plain path {p!r} ms, "
                     f"{p_dev!r} ms device (busy {p_dev / p!r})")
    net = kstate.model
    infer = prog.make_progressive_infer_step(net, PROG_MAX)

    def plain_infer():
        with plain_on_cuda():
            infer(kstate, x)

    k, p = _pair_ms(torch, lambda: infer(kstate, x), plain_infer, 5)
    parts.append(f"progressive infer step: kernel path {k!r} ms, plain path "
                 f"{p!r} ms")
    ae, _, _ = _recon_state(torch, "ae")
    pcfg = prog.ProgressiveAEConfig(batch_size=RECON_B)
    scfg = rec.SampleNetAEConfig(num_out_points=pcfg.max_num_out_points,
                                 batch_size=RECON_B)
    ae_steps = []
    for _ in range(2):
        sampler, state = rec.create_sampler_ae_state(scfg, device=DEVICE,
                                                     seed=SEED + 1)
        ae_steps.append((state, prog.make_progressive_ae_train_step(
            sampler, ae, pcfg)))
    (ks, kstep), (ps, pstep) = ae_steps

    def kernel_ae():
        kstep(ks, recon_x)

    def plain_ae():
        with plain_on_cuda():
            pstep(ps, recon_x)

    k, p = _pair_ms(torch, kernel_ae, plain_ae, 3)
    k_dev = _device_ms(torch, kernel_ae, 3)
    p_dev = _device_ms(torch, plain_ae, 3)
    log("profile", f"progressive AE step, kernel path: "
                   f"{_profile_top(torch, kernel_ae, 3)} ({card})")
    parts.append(f"progressive AE step, B={RECON_B}, {RECON_N} points, sizes "
                 f"{pcfg.sizes[0]}..{pcfg.sizes[-1]}: kernel path {k!r} ms "
                 f"= {RECON_B / k * 1e3!r} clouds/s, {k_dev!r} ms device "
                 f"(busy {k_dev / k!r}); plain path {p!r} ms, {p_dev!r} ms "
                 f"device (busy {p_dev / p!r})")
    log("times-progressive", " | ".join(parts) + f" ({card})")
    torch.cuda.empty_cache()
    return times


# ------------------------------------------------------ registration phases

def _reg_soft_check(torch, pts, qs, sigma, cot, plans) -> str:
    """The soft projection at the registration shape under each (fwd, bwd)
    plan against its plain version: idx bit-equal, out within atol 1e-5,
    the gradients within rtol 1e-4 / atol 1e-5, and the backward's bits the
    same under every plan and from run to run."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    k = REG_K
    op, ip = spk.soft_project_fwd_plain(pts, qs, sigma, k)
    gp = spk.soft_project_bwd_plain(pts, qs, sigma, ip, cot)
    first = None
    for fplan, bplan in plans:
        ok, ik = spk.launch_fwd(pts, qs, sigma, k, fplan)
        if not torch.equal(ik, ip):
            raise AssertionError(f"soft_projection (registration) {fplan}: "
                                 f"idx differ in {int((ik != ip).sum())} "
                                 f"places")
        torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
        for _ in range(2):
            gk = spk.launch_bwd(pts, qs, sigma, ik, cot, bplan)
            torch.cuda.synchronize()
            for a, c in zip(gk, gp):
                torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
            if first is None:
                first = gk
            elif not all(torch.equal(a, c) for a, c in zip(gk, first)):
                raise AssertionError(f"soft_projection backward "
                                     f"(registration) {bplan}: bits differ "
                                     f"from the first plan's or run's")
    return (f"soft_projection points{tuple(pts.shape)} queries"
            f"{tuple(qs.shape)} k={k} under {len(plans)} plans (planned "
            f"first: {plans[0]}): idx bit-equal, out max |k - p| "
            f"{float((ok - op).abs().max())!r} (atol 1e-5), d points / d "
            f"queries / d sigma^2 within rtol 1e-4 / atol 1e-5, the backward "
            f"bit-equal across plans and runs")


def phase_compare_registration(torch) -> None:
    """The kernels at the shapes the registration path gives them, each
    under its launch plan and one other, against its plain version: the
    soft projection at (32, 1024, 64, k=8), FPS at 1024 -> 64 with count 1
    (FPSSampler) and with the matching's counts, bit for bit. nn_direction
    at the registration shapes is phase_compare_nn's (NN_SHAPES)."""
    from samplenet_tpu_torch.ops.cuda import fps_kernel as fk
    from samplenet_tpu_torch.ops.cuda import fps_plan
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda.soft_projection_plan import (
        BwdPlan,
        FwdPlan,
    )

    rng = np.random.default_rng(SEED + 30)
    b, n, m = REG_B, REG_N, REG_M
    pts, qs, sigma, cot = _soft_inputs(torch, rng, b, n, m)
    sigma = sigma.reshape(1)
    fplan = spk.fwd_plan(pts.device.index, b, n, m)
    bplan = spk.bwd_plan(pts.device.index, b, n, m, REG_K)
    fother, bother = FwdPlan(64, 3, 2, (b, 0)), BwdPlan(64, 32, 128)
    if fother == fplan or bother == bplan:
        raise AssertionError(f"the other plans are the planned ones: "
                             f"{fplan}, {bplan}")
    log("compare-registration", _reg_soft_check(
        torch, pts, qs, sigma, cot, [(fplan, bplan), (fother, bother)]))
    _, y, given, count = _inputs(torch, rng, DEVICE, b, n, m)
    plan = fk.kernel_plan(y.device.index, b, n, m)
    other = next(p for p in fps_plan.candidates(n) if p != plan)
    for label, cnt in (("count 1 (FPSSampler)", torch.ones_like(count)),
                       (f"counts {int(count.min())}..{int(count.max())} "
                        f"(the matching's completion)", count)):
        ip, xp = fk.fps_plain(y, given, cnt, m)
        for p in (plan, other):
            ik, xk = fk.launch(y, given, cnt, m, p)
            torch.cuda.synchronize()
            if not (torch.equal(ik, ip) and torch.equal(xk, xp)):
                raise AssertionError(f"fps (registration) {label} {p}: "
                                     f"kernel != plain ({int((ik != ip).sum())}"
                                     f" idx differ)")
        log("compare-registration", f"fps points{tuple(y.shape)} k={m} "
                                    f"{label} under {plan} and {other}: idx "
                                    f"and xyz bit-equal")


def _reg_data(torch):
    """B pairs of procedural 1024-point clouds under the dataset's fixed
    random rotations (seed 0), on the card: (p0, p1, twist)."""
    from samplenet_tpu_torch.data import QuaternionFixedDataset, make_dataset

    data, _ = make_dataset(REG_B, REG_N, seed=SEED)
    ds = QuaternionFixedDataset(data, seed=SEED)
    batch = next(ds.batches(REG_B, shuffle=False))
    return tuple(torch.from_numpy(a).to(DEVICE) for a in batch)


def _reg_state(torch, which, *, dtype=None, pcrnet=None):
    """A seeded PCRNet (which="pcrnet") or registration sampler and its
    train step; the sampler trains against `pcrnet` (a copy in `dtype`
    where one is given)."""
    from samplenet_tpu_torch.train import registration as reg

    cfg = reg.RegistrationConfig()
    if which == "pcrnet":
        model, state = reg.create_pcrnet_state(cfg, device=DEVICE,
                                               seed=SEED + 31)
        if dtype is not None:
            model.to(dtype)       # in place: the optimiser keeps its params
        return model, state, reg.make_pcrnet_train_step(model, cfg)
    model, state = reg.create_sampler_state(cfg, device=DEVICE,
                                            seed=SEED + 32)
    if dtype is not None:
        model.to(dtype)
        pcrnet = copy.deepcopy(pcrnet).to(dtype)
    return model, state, reg.make_sampler_train_step(model, pcrnet, cfg)


def _reg_pcrnet(torch):
    """The frozen task network of phase 2: PCRNet from SEED + 33, its
    weights moved off flax's initialisation by one seeded phase-1 step's
    worth of noise (so its outputs are not those of a fresh net)."""
    from samplenet_tpu_torch.models import PCRNet

    pcrnet = PCRNet(generator=torch.Generator().manual_seed(SEED + 33))
    gen = torch.Generator().manual_seed(SEED + 34)
    with torch.no_grad():
        for p in pcrnet.parameters():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
    return pcrnet.to(DEVICE)


@contextlib.contextmanager
def choices(torch, *, record: list | None = None,
            replay: list | None = None):
    """Within the block, a train step's discrete choices are appended to
    `record` as the step makes them: the Chamfer losses' 1-NN indices
    (ops/chamfer.py), the soft projection's neighbour sets (models/
    soft_projection.py), and the frozen PCRNet's ReLU masks and max-pool
    argmaxes (models/pcrnet.py); or, with `replay`, taken from it in
    order instead of made, the projection recomputed on the replayed
    neighbours and PCRNet's features on the replayed masks and argmaxes,
    with torch ops in the inputs' dtype. Under tensor parallelism the
    masks and argmaxes of a sharded PCRNet layer are recorded whole
    (all-gathered over the model group), so that one process replays
    them. A float64 step that replays an
    f32 step's choices computes the function the f32 step computed: where
    an f32 input to a choice lands a near-tie apart from f64's, the choice
    moves and the gradient with it (at the registration shapes by 1e-3 to
    2e-2 norm-wise on either f32 path; PERF.md). The sampler's own ReLU
    masks and max-pool choices, inside the exact-BN kernel, are not
    replayed."""
    import samplenet_tpu_torch.models.pcrnet as pcr_mod
    import samplenet_tpu_torch.models.soft_projection as sp_mod
    import samplenet_tpu_torch.ops.chamfer as chamfer_mod
    from samplenet_tpu_torch.nn.layers import local, whole_channels
    from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import _weights
    from samplenet_tpu_torch.ops.knn import group_point

    nn0, sp0 = chamfer_mod.nn_direction, sp_mod.soft_project
    mlp0 = pcr_mod.point_mlp
    taken = iter(replay if replay is not None else ())

    def nn_direction(a, b):
        if replay is not None:
            return None, next(taken)
        out = nn0(a, b)
        record.append(out[1])
        return out

    def soft_project(points, queries, sigma, k):
        if replay is None:
            out = sp0(points, queries, sigma, k)
            record.append(out[1])
            return out
        idx = next(taken)
        g = group_point(points, idx)
        delta = g - queries[:, :, None, :]
        d = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]) \
            + delta[..., 2] * delta[..., 2]
        w = _weights(d, sigma.reshape(()))
        return (w[..., None] * g).sum(2), idx

    def whole(conv, t):
        """t of a (sharded) conv's channels, whole: all-gathered over the
        model group outside the port's counted collectives (the record is
        not the step's)."""
        mesh = getattr(conv, "shard", None)
        if mesh is None:
            return t
        u = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(u) for _ in range(mesh.model)]
        torch.distributed.all_gather(parts, u, group=mesh.model_group)
        return torch.cat(parts, -1).to(t.dtype)

    def mine(conv, t):
        """This rank's channels of a whole replayed t."""
        return local(conv, t.movedim(-1, 0)).movedim(0, -1)

    def point_mlp(owner, n_layers, x, *, pool_max, use_bn):
        if use_bn or not pool_max:
            raise AssertionError("PCRNet's features: no BN, max-pooled")
        for i in range(n_layers):
            conv = getattr(owner, f"conv{i + 1}")
            x = conv(x)
            if replay is None:
                record.append(whole(conv, x > 0))
                x = torch.relu(x)
            else:
                x = x * mine(conv, next(taken)).to(x.dtype)
            if i < n_layers - 1:
                x = whole_channels(conv, x)
        if replay is None:
            record.append(whole(conv, x.argmax(1)))
            return whole_channels(conv, x.amax(1))
        idx = mine(conv, next(taken))
        return whole_channels(conv, x.gather(1, idx[:, None, :]).squeeze(1))

    chamfer_mod.nn_direction, sp_mod.soft_project = nn_direction, soft_project
    pcr_mod.point_mlp = point_mlp
    try:
        yield
    finally:
        chamfer_mod.nn_direction, sp_mod.soft_project = nn0, sp0
        pcr_mod.point_mlp = mlp0
    if replay is not None and next(taken, None) is not None:
        raise AssertionError("the replayed step made fewer choices than the "
                             "recorded one")


def _reg_step_check(torch, which, batch, pcrnet=None) -> str:
    """One step of phase `which` on the kernel path and on the plain path
    from the same seeded state, each with its discrete choices recorded
    and replayed by a float64 plain step (`choices`): every loss term
    within rtol 1e-4 of the plain path's and of its own f64 replay's, each
    gradient's norm-wise error against its f64 replay at most twice the
    plain f32 path's (or 1e-4); gradients zero in exact arithmetic
    (CANCELLED) round-off on both paths, the conv biases' exactly 0 on the
    kernel path. The error against an f64 step that makes its own choices
    is printed beside, with the choices the two f32 paths make apart."""
    f64 = torch.float64
    runs = {}
    for name, plain in (("kernel", False), ("plain", True), ("f64", True)):
        made, out = [], {}
        for dtype in ((None, f64) if name != "f64" else (f64,)):
            model, state, step = _reg_state(torch, which, dtype=dtype,
                                            pcrnet=pcrnet)
            args = batch if dtype is None else [t.to(dtype) for t in batch]
            how = (contextlib.nullcontext() if name == "f64" else
                   choices(torch, record=made) if dtype is None else
                   choices(torch, replay=made))
            with _ctx(plain or dtype is not None), how:
                metrics = step(state, *args)
            torch.cuda.synchronize()
            out[dtype] = (metrics, {k: p.grad.detach().clone()
                                    for k, p in model.named_parameters()})
            del model, state, step
        runs[name] = (out, made)
    (mk, gk), (mkr, gkr) = runs["kernel"][0][None], runs["kernel"][0][f64]
    (mp, gp), (mpr, gpr) = runs["plain"][0][None], runs["plain"][0][f64]
    _, gr = runs["f64"][0][f64]
    apart = sum(int((a != c).sum()) for a, c in zip(runs["kernel"][1],
                                                     runs["plain"][1]))
    for k in mk:
        if not bool(torch.isfinite(mk[k])):
            raise AssertionError(f"registration {which} step: {k} is not "
                                 f"finite")
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=0)
        torch.testing.assert_close(mk[k].double(), mkr[k], rtol=1e-4, atol=0)
        torch.testing.assert_close(mp[k].double(), mpr[k], rtol=1e-4, atol=0)
    scale = max(float(g.abs().max()) for g in gkr.values())
    worst, own = (0.0, 0.0, ""), (0.0, 0.0)
    for name in gk:
        if which == "sampler" and name in CANCELLED:
            for g in (gk[name], gp[name]):
                if float(g.abs().max()) > 1e-4 * scale:
                    raise AssertionError(f"registration {name}: gradient "
                                         f"not round-off")
            if name.startswith("conv") and bool(gk[name].any()):
                raise AssertionError(f"registration {name}: kernel "
                                     f"gradient is not 0")
            continue
        ek, ep = _norm_err(gk[name], gkr[name]), _norm_err(gp[name],
                                                           gpr[name])
        if not ek <= max(2 * ep, 1e-4):
            raise AssertionError(f"registration {which} {name}: kernel "
                                 f"error {ek!r} of its f64 replay's norm, "
                                 f"plain f32 {ep!r}")
        worst = max(worst, (ek, ep, name))
        own = max(own, (_norm_err(gk[name], gr[name]),
                        _norm_err(gp[name], gr[name])))
    torch.cuda.empty_cache()
    return (f"{which} step at B={REG_B}, {REG_N} points: " + ", ".join(
        f"{k} {float(v)!r} (plain {float(mp[k])!r}, f64 replay "
        f"{float(mkr[k])!r})" for k, v in mk.items())
        + f"; gradients' norm-wise error against the f64 replay of the "
          f"path's own choices: worst kernel {worst[0]!r} at {worst[2]} "
          f"(plain f32 {worst[1]!r}); against an f64 step making its own "
          f"choices: worst kernel {own[0]!r}, plain {own[1]!r}; choices "
          f"apart between the kernel and the plain path: {apart} of "
          f"{sum(t.numel() for t in runs['kernel'][1])}")


def _reg_eval_check(torch, batch, pcrnet) -> str:
    """The eval step with the seeded sampler (hard matching) and with
    FPSSampler, on the kernel path and the plain path: the sampled clouds
    bit-equal, the rotation errors and consistencies within rtol 1e-4."""
    from samplenet_tpu_torch.models import FPSSampler
    from samplenet_tpu_torch.train import registration as reg

    cfg = reg.RegistrationConfig()
    sampler, _, _ = _reg_state(torch, "sampler", pcrnet=pcrnet)
    parts = []
    for name, smp in (("samplenet", sampler),
                      ("fps", FPSSampler(REG_M, permute=False))):
        step = reg.make_eval_step(smp, pcrnet, cfg)
        runs = []
        for plain in (False, True):
            with _ctx(plain), torch.inference_mode():
                samples = [smp(p, training=False)[1] for p in batch[:2]]
                runs.append((samples, step(*batch)))
            torch.cuda.synchronize()
        (sk, (rk, tk, ck)), (sp, (rp, tp, cp)) = runs
        if not all(torch.equal(a, c) for a, c in zip(sk, sp)):
            raise AssertionError(f"registration eval ({name}): the sampled "
                                 f"clouds differ from the plain path's")
        for a, c in ((rk, rp), (tk, tp), (ck, cp)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"registration eval ({name}): not "
                                     f"finite")
            torch.testing.assert_close(a, c, rtol=1e-4, atol=0)
        parts.append(f"{name}: rotation errors {float(rk.mean())!r} deg "
                     f"mean (plain {float(rp.mean())!r}), consistency "
                     f"{float(ck.mean())!r}")
    return ("eval steps, kernel path vs plain path (samples bit-equal, "
            "errors within rtol 1e-4): " + "; ".join(parts))


def phase_registration_step(torch) -> dict[str, dict[str, float]]:
    """At full width, one phase-1 PCRNet step and one phase-2 sampler step
    on the kernel path, the plain path and the plain path in f64, and the
    eval steps; then the track's main path, each part with the launch
    counters reset just before it and read just after: REG_STEPS PCRNet
    steps, REG_STEPS sampler steps, one eval step with the sampler and one
    with FPSSampler. Returns each part's launches a step."""
    from samplenet_tpu_torch.models import FPSSampler
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import registration as reg

    batch = _reg_data(torch)
    pcrnet = _reg_pcrnet(torch)
    log("registration", _reg_step_check(torch, "pcrnet", batch))
    log("registration", _reg_step_check(torch, "sampler", batch, pcrnet))
    log("registration", _reg_eval_check(torch, batch, pcrnet))

    cfg = reg.RegistrationConfig()
    sampler, s_state, s_step = _reg_state(torch, "sampler", pcrnet=pcrnet)
    _, p_state, p_step = _reg_state(torch, "pcrnet")
    runs = {   # part -> (what it runs, how many steps)
        "pcrnet": (lambda: [p_step(p_state, *batch)["loss"]
                            for _ in range(REG_STEPS)], REG_STEPS),
        "sampler": (lambda: [s_step(s_state, *batch)["loss"]
                             for _ in range(REG_STEPS)], REG_STEPS),
        "eval": (lambda: reg.make_eval_step(sampler, pcrnet, cfg)(*batch),
                 1),
        "eval (FPSSampler)": (lambda: reg.make_eval_step(
            FPSSampler(REG_M, permute=False), pcrnet, cfg)(*batch), 1),
    }
    outs, per_step, total = {}, {}, {}
    for part, (run, steps) in runs.items():
        reset_launch_counts()
        outs[part] = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        per_step[part] = {k: v / steps for k, v in counts.items()}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if p_state.optimizer.count != REG_STEPS \
            or s_state.optimizer.count != REG_STEPS \
            or not all(bool(torch.isfinite(t).all())
                       for out in outs.values() for t in out):
        raise AssertionError(f"registration path: {outs}")
    missing = [k for k in REG_PATH if total.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"the registration path launched no {missing}: "
                             f"{per_step}")
    losses = {k: [float(v) for v in outs[k]] for k in ("pcrnet", "sampler")}
    log("registration", f"{REG_STEPS} PCRNet steps, {REG_STEPS} sampler "
                        f"steps (m={REG_M}, k={REG_K}, both clouds) at "
                        f"B={REG_B}, {REG_N} points: losses {losses}; eval "
                        f"steps (sampler, FPSSampler) rotation errors "
                        f"{float(outs['eval'][0].mean())!r}, "
                        f"{float(outs['eval (FPSSampler)'][0].mean())!r} deg "
                        f"mean; kernel launches a step: " + "; ".join(
                            f"{part} {c}" for part, c in per_step.items()))
    return per_step


def phase_registration_cli(torch) -> None:
    """train_registration on the card: --phase pcrnet for one epoch of 3
    steps with the FPS baselines at 32 (and 64), then --phase samplenet on
    its checkpoint; each report.json finite."""
    base = ["samplenet_tpu_torch.train.train_registration", "--device",
            "cuda", "--epochs", "1", "--steps-per-epoch", "3",
            "--train-size", "96", "--test-size", "64"]
    with tempfile.TemporaryDirectory() as tmp:
        pcr, sn = os.path.join(tmp, "pcrnet"), os.path.join(tmp, "sn")
        out1, s1 = _cli(base + ["--phase", "pcrnet", "--fps-eval-sizes",
                                "32", "--log-dir", pcr],
                        "train_registration --phase pcrnet")
        out2, s2 = _cli(base + ["--phase", "samplenet", "--pcrnet-ckpt",
                                os.path.join(pcr, "ckpt"), "--log-dir", sn],
                        "train_registration --phase samplenet")
        reports = {}
        for name, d, keys in (("pcrnet", pcr, ("full_iter1", "fps32_iter1",
                                               "fps64_iter1")),
                              ("samplenet", sn, ("best",))):
            with open(os.path.join(d, "report.json")) as f:
                rep = json.load(f)
            for key in keys:
                vals = [rep[key][v] for v in ("auc", "rot_err_mean",
                                              "rot_err_std",
                                              "consistency_mean")]
                if not all(np.isfinite(vals)):
                    raise AssertionError(f"train_registration --phase {name}"
                                         f" wrote {key}: {rep[key]}")
                reports[f"{name} {key}"] = rep[key]
        for rel in ("pcrnet/ckpt/pcrnet.pth", "sn/ckpt/sampler.pth"):
            if not os.path.exists(os.path.join(tmp, rel)):
                raise AssertionError(f"train_registration wrote no {rel}")
    if "device=NVIDIA" not in out1 or "frozen PCRNet" not in out2:
        raise AssertionError(f"train_registration logged:\n{out1}\n{out2}")
    log("registration-cli", f"--phase pcrnet --fps-eval-sizes 32: exit 0 in "
                            f"{s1:.1f} s; --phase samplenet --pcrnet-ckpt: "
                            f"exit 0 in {s2:.1f} s; reports " + "; ".join(
                                f"{k}: AUC {v['auc']!r}, rotation error "
                                f"{v['rot_err_mean']!r} deg"
                                for k, v in reports.items()))


def phase_times_registration(torch, per_step, card) -> None:
    """The registration kernels at their shapes (the soft projection at
    k=8, the exact-BN chain, point_mlp_max, FPS with count 1 and with the
    matching's counts) per call and as device time against the plain
    version, with their bounds and launches a step; then the phase-1 step,
    the phase-2 step and the eval step, kernel path against plain path in
    A B B A order, per step and device time and busy share."""
    from samplenet_tpu_torch.models import FPSSampler
    from samplenet_tpu_torch.ops.cuda import fps, fps_plain
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda
    from samplenet_tpu_torch.train import registration as reg

    rng = np.random.default_rng(SEED + 35)
    b, n, m, k = REG_B, REG_N, REG_M, REG_K
    pts, qs, sigma, cot = _soft_inputs(torch, rng, b, n, m)
    sigma = sigma.reshape(1)
    idx = spk.soft_project_fwd_cuda(pts, qs, sigma, k)[1]
    x, (ws, _, gs, bes), g = _exact_inputs(torch, rng, b, n)
    saved_k = pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5)[3]
    saved_p = pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5)[3]
    _, y, given, count = _inputs(torch, rng, DEVICE, b, n, m)
    ones = torch.ones_like(count)
    wbs = _mlp_weights(torch, rng, DEVICE)
    exact_fwd, exact_bwd = _exact_bounds(b, n, WIDTHS)
    pairs = list(zip(WIDTHS[:-1], WIDTHS[1:]))
    macs, params = (sum(a * c for a, c in pairs),
                    sum(a * c + c for a, c in pairs))
    cases = {
        "soft_projection_fwd": (
            lambda: spk.soft_project_fwd_cuda(pts, qs, sigma, k),
            lambda: spk.soft_project_fwd_plain(pts, qs, sigma, k),
            _soft_fwd_bound(b, n, m, k), "sampler"),
        "soft_projection_bwd": (
            lambda: spk.soft_project_bwd_cuda(pts, qs, sigma, idx, cot),
            lambda: spk.soft_project_bwd_plain(pts, qs, sigma, idx, cot),
            _soft_bwd_bound(b, n, m, k, _gathered(torch, idx, n)),
            "sampler"),
        "point_mlp_exact_fwd": (
            lambda: pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5),
            lambda: pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5),
            exact_fwd, "sampler"),
        "point_mlp_exact_bwd": (
            lambda: pme.point_mlp_exact_bwd_cuda(x, ws, gs, bes, saved_k, g),
            lambda: pme.point_mlp_exact_bwd_plain(x, ws, gs, bes, saved_p,
                                                  g),
            exact_bwd, "sampler"),
        "point_mlp_max": (
            lambda: point_mlp_max(y, wbs), lambda: point_mlp_max_plain(y, wbs),
            _bound(4 * (b * n * 3 + params + b * WIDTHS[-1]),
                   (b * n * 3 * 2.0 * macs, TF32_FLOP_PER_S),
                   (b * n * 3.0 * sum(WIDTHS[1:]), FP32_FLOP_PER_S)), "eval"),
        "fps (count 1, FPSSampler)": (
            lambda: fps(y, given, ones, m),
            lambda: fps_plain(y, given, ones, m), _fps_bound(b, n, m),
            "eval (FPSSampler)"),
        "fps (the matching's counts)": (
            lambda: fps(y, given, count, m),
            lambda: fps_plain(y, given, count, m), _fps_bound(b, n, m),
            "eval"),
    }
    for name, (kernel_fn, plain_fn, bound, part) in cases.items():
        k_ms, p_ms = _pair_ms(torch, kernel_fn, plain_fn, 10)
        k_dev = _device_ms(torch, kernel_fn, 10)
        p_dev = _device_ms(torch, plain_fn, 3)
        launches = per_step[part].get(name.split(" ")[0], 0)
        log("times-registration",
            f"{name} at the registration shape (B={b}, N={n}, M={m}"
            f"{f', k={k}' if name.startswith('soft') else ''}): kernel "
            f"{k_ms!r} ms per call, {k_dev!r} ms device; plain {p_ms!r} ms "
            f"per call, {p_dev!r} ms device; bound {bound[0]!r} ms "
            f"({bound[1]}); {launches!r} launches per {part} step ({card})")
    del saved_k, saved_p
    torch.cuda.empty_cache()

    batch = _reg_data(torch)
    pcrnet = _reg_pcrnet(torch)
    cfg = reg.RegistrationConfig()
    steps = {}
    for part in ("pcrnet", "sampler"):
        _, kstate, kstep = _reg_state(torch, part, pcrnet=pcrnet)
        _, pstate, pstep = _reg_state(torch, part, pcrnet=pcrnet)
        steps[part] = (lambda kstep=kstep, kstate=kstate:
                       kstep(kstate, *batch),
                       lambda pstep=pstep, pstate=pstate:
                       pstep(pstate, *batch))
    sampler, _, _ = _reg_state(torch, "sampler", pcrnet=pcrnet)
    eval_step = reg.make_eval_step(sampler, pcrnet, cfg)
    steps["eval"] = (lambda: eval_step(*batch), lambda: eval_step(*batch))
    fps_step = reg.make_eval_step(FPSSampler(REG_M, permute=False), pcrnet,
                                  cfg)
    steps["eval (FPSSampler)"] = (lambda: fps_step(*batch),
                                  lambda: fps_step(*batch))
    for part, (kernel_step, plain_fn) in steps.items():
        def plain_step(plain_fn=plain_fn):
            with plain_on_cuda():
                plain_fn()

        k_ms, p_ms = _pair_ms(torch, kernel_step, plain_step, 5)
        k_dev = _device_ms(torch, kernel_step, 3)
        p_dev = _device_ms(torch, plain_step, 3)
        log("profile", f"registration {part} step, kernel path: "
                       f"{_profile_top(torch, kernel_step, 3)} ({card})")
        log("times-registration",
            f"registration {part} step, B={REG_B}, {REG_N} points: kernel "
            f"path {k_ms!r} ms = {REG_B / k_ms * 1e3!r} pairs/s, {k_dev!r} "
            f"ms device (busy {k_dev / k_ms!r}); plain path {p_ms!r} ms, "
            f"{p_dev!r} ms device (busy {p_dev / p_ms!r}) ({card})")
        torch.cuda.empty_cache()


# ------------------------------------------------------------ the bf16 modes

def _exact_bf16_gaps(torch, x, groups, g, bf16: bool):
    """(outputs gap, backward gap, max |d pooled|, max |d grads|): the exact
    chain's kernels with bf16 on or off against the plain bf16 version,
    norm-wise: the forward's pooled features and statistics, and the
    backward's gradients against the plain backward run on the kernel
    forward's own state (its z, statistics and argmax), so that only sums
    taken in other orders part the two."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme

    weights, _, gammas, betas = groups
    fk = pme.point_mlp_exact_fwd_cuda(x, weights, gammas, betas, 1e-5, bf16)
    fp = pme.point_mlp_exact_fwd_plain(x, weights, gammas, betas, 1e-5, True)
    bk = pme.point_mlp_exact_bwd_cuda(x, weights, gammas, betas, fk[3], g,
                                      bf16)
    zs, mus, rstds, argmax = fk[3]
    bp = pme.point_mlp_exact_bwd_plain(x, weights, gammas, betas,
                                       (zs, mus, rstds, argmax.long()), g,
                                       True)
    torch.cuda.synchronize()
    outs = list(zip([fk[0], *fk[1], *fk[2]], [fp[0], *fp[1], *fp[2]]))
    flat = lambda gr: [gr[0], *gr[1], *gr[2], *gr[3]]  # noqa: E731
    grads = list(zip(flat(bk), flat(bp)))
    return (max(_norm_err(a, r) for a, r in outs),
            max(_norm_err(a, r) for a, r in grads),
            float((fk[0] - fp[0]).abs().max()),
            max(float((a - r).abs().max()) for a, r in grads))


def _max_bf16_gaps(torch, rng, b, n, widths):
    """(kernel gap, bf16-off control gap, max |d|): point_mlp_max in bf16,
    and the f32 kernel, against the plain bf16 version, norm-wise."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain

    x = _randn(torch, rng, b, n, widths[0])
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [_randn(torch, rng, cin, cout) / cin ** 0.5,
                0.1 * _randn(torch, rng, cout)]
    with torch.no_grad():
        k = point_mlp_max(x, wbs, bf16=True)
        c = point_mlp_max(x, wbs)
        p = point_mlp_max_plain(x, wbs, True)
    torch.cuda.synchronize()
    return _norm_err(k, p), _norm_err(c, p), float((k - p).abs().max())


def phase_compare_bf16(torch) -> dict[str, float]:
    """The two kernels' bf16 modes against their plain bf16 versions,
    norm-wise within BF16_TOL, each with the kernel run with bf16 off as a
    control that must exceed it (for point_mlp_max, on chains of three or
    more layers): the exact-BN chain (forward, and backward
    on its own forward state) at the classification step's shape (B=1024)
    and at a ragged one, bit for bit from run to run; point_mlp_max at the
    eval shape (B=1024), the registration eval shape (B=32) and ragged
    ones."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme

    rng = np.random.default_rng(SEED + 40)
    errs = {}
    for b, n, widths in ((B, N, WIDTHS), (RAGGED_B, RAGGED_N, WIDTHS),
                         (RECON_B, RECON_N, RECON_WIDTHS)):
        x, groups, g = _exact_inputs(torch, rng, b, n, widths)
        k = _exact_bf16_gaps(torch, x, groups, g, True)
        c = _exact_bf16_gaps(torch, x, groups, g, False)
        weights, _, gammas, betas = groups
        fk = pme.point_mlp_exact_fwd_cuda(x, weights, gammas, betas, 1e-5,
                                          True)
        runs = [pme.point_mlp_exact_bwd_cuda(x, weights, gammas, betas,
                                             fk[3], g, True)
                for _ in range(2)]
        flat = lambda gr: [gr[0], *gr[1], *gr[2], *gr[3]]  # noqa: E731
        same = all(torch.equal(a, r)
                   for a, r in zip(flat(runs[0]), flat(runs[1])))
        log("compare-bf16", f"point_mlp_exact bf16 at B={b}, N={n}, "
                            f"{widths}: outputs {k[0]!r}, backward on its "
                            f"own state {k[1]!r} (limit {BF16_TOL}); bf16 "
                            f"off {c[0]!r}, {c[1]!r}; backward bits repeat "
                            f"{same}")
        if not (k[0] <= BF16_TOL and k[1] <= BF16_TOL and same):
            raise AssertionError(f"point_mlp_exact bf16 at B={b}: {k}")
        if not (c[0] > BF16_TOL and c[1] > BF16_TOL):
            raise AssertionError(f"the bf16-off control passes: {c}")
        if b == B:
            errs["point_mlp_exact_bf16_fwd"] = k[2]
            errs["point_mlp_exact_bf16_bwd"] = k[3]
    for b, n, widths in ((B, N, WIDTHS), (REG_B, REG_N, WIDTHS),
                         (5, 1000, WIDTHS), (3, 77, (3, 12, 20)),
                         (4, 300, (16, 24, 8)),
                         (RECON_B, RECON_N, RECON_WIDTHS)):
        k, c, d = _max_bf16_gaps(torch, rng, b, n, widths)
        log("compare-bf16", f"point_mlp_max bf16 at B={b}, N={n}, {widths}: "
                            f"{k!r} (limit {BF16_TOL}); bf16 off {c!r}")
        # two layers round too few times for the control to show (1.3e-3
        # at 16 -> 24 -> 8 in the first card run): it is held at 3 or more
        if not (k <= BF16_TOL and (c > BF16_TOL or len(widths) <= 3)):
            raise AssertionError(f"point_mlp_max bf16 at B={b}: {k}, {c}")
        if b == B:
            errs["point_mlp_max_bf16"] = d
        torch.cuda.empty_cache()
    return errs


def _eval_bf16_model(torch, model):
    """The serving model's weights in a SampleNet with eval_bf16."""
    from samplenet_tpu_torch.models import SampleNet

    net = SampleNet(num_out_points=M, bottleneck_size=128, eval_bf16=True)
    net.load_state_dict(model.state_dict())
    return net.to(DEVICE).eval()


def _bf16_step(torch, classifier, **cfg):
    """A fresh classification sampler state from SEED with
    SampleNetConfig(**cfg) and its train step (augmentation off)."""
    from samplenet_tpu_torch.train.classification import (
        SampleNetConfig,
        create_samplenet_state,
        make_samplenet_train_step,
    )

    scfg = SampleNetConfig(batch_size=B, **cfg)
    net, state = create_samplenet_state(scfg, device=DEVICE, seed=SEED)
    return net, state, make_samplenet_train_step(net, classifier, scfg,
                                                 augment_data=False)


def phase_bf16(torch, model, clouds, data, labels, classifier
               ) -> dict[str, int]:
    """The main paths of the bf16 modes, each with the launch counters set
    to 0 before it and read after: the eval forward with hard matching at
    B=1024 with eval_bf16 (point_mlp_max in bf16), its matching bit for
    bit against the plain matcher on the kernel path's own simplified
    cloud; the classification sampler step at B=1024, k=7, with the exact
    chain in bf16 (fused_train, fused_mode "exact", fused_bf16), its step
    against the plain bf16 path (loss terms within rtol 1e-3, gradients
    within 5e-2 norm-wise, which the kernel step with bf16 off must
    exceed); and with the compute dtype (SampleNetConfig(bf16=True): no
    conv kernel, cuBLAS bf16), against the plain path (loss terms within
    rtol 1e-4)."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds

    x = torch.from_numpy(clouds).to(DEVICE)
    net = _eval_bf16_model(torch, model)
    reset_launch_counts()
    with torch.inference_mode():
        simp, matched = net(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    with torch.inference_mode():
        pts_k, idx_k = nn_match_from_clouds(x, simp, M)
        with plain_on_cuda():
            pts_p, idx_p = nn_match_from_clouds(x, simp, M)
            simp_p = net.simplify(x)
        simp_f32 = model.simplify(x)
    torch.cuda.synchronize()
    if counts.get("point_mlp_max_bf16", 0) < 1 or counts.get(
            "point_mlp_max", 0) or any(counts.get(k, 0) < 1
                                       for k in ("nn_direction", "fps")):
        raise AssertionError(f"bf16 eval path launched {counts}")
    if not (torch.equal(idx_k, idx_p) and torch.equal(pts_k, pts_p)
            and torch.equal(matched, pts_k)):
        raise AssertionError("bf16 eval: matching differs from the plain "
                             "matcher on the kernel's simplified cloud")
    log("bf16", f"eval forward + matching, B={B}, eval_bf16: launches "
                f"{counts}; matched idx and points bit-equal to the plain "
                f"matcher's on the kernel path's simplified cloud; simplified "
                f"vs the plain bf16 path max |d| "
                f"{float((simp - simp_p).abs().max())!r}, vs the f32 kernel "
                f"path {float((simp - simp_f32).abs().max())!r}")
    main = {"eval": counts}

    xt = torch.from_numpy(data).to(DEVICE)
    y = torch.from_numpy(labels).to(DEVICE)
    fused = dict(fused_train=True, fused_mode="exact", fused_bf16=True)
    soft = ("soft_projection_fwd", "soft_projection_bwd", "nn_direction")
    exact = ("point_mlp_exact_fwd", "point_mlp_exact_bwd")
    exact16 = ("point_mlp_exact_bf16_fwd", "point_mlp_exact_bf16_bwd")
    # (tag, config, kernels it must launch, kernels it must not, the
    # bf16-off control's config or None)
    for tag, cfg, need, absent, control in (
            ("exact chain in bf16", fused, exact16 + soft, exact,
             {**fused, "fused_bf16": False}),
            ("compute dtype bf16", dict(bf16=True), soft, exact + exact16,
             None)):
        runs = {}
        for path, plain, c in (("kernel", False, cfg), ("plain", True, cfg),
                               ("bf16 off", False, control)):
            if c is None:
                continue
            net_s, state, step = _bf16_step(torch, classifier, **c)
            with _ctx(plain):
                metrics = step(state, xt, y)
            torch.cuda.synchronize()
            runs[path] = (metrics, {k: p.grad.detach().clone()
                                    for k, p in net_s.named_parameters()})
            del net_s, state, step
        mk, gk = runs["kernel"]
        mp, gp = runs["plain"]
        rtol = 1e-3 if control else 1e-4
        for k in ("loss", "task", "simplification", "projection"):
            if not bool(torch.isfinite(mk[k])):
                raise AssertionError(f"{tag}: {k} is not finite")
            torch.testing.assert_close(mk[k], mp[k], rtol=rtol, atol=0)
        names = [n for n in gk if n not in CANCELLED]
        gap = max(_norm_err(gk[n], gp[n]) for n in names)
        line = (f"one step at B={B}, {tag}: loss {float(mk['loss'])!r} "
                f"(plain {float(mp['loss'])!r}), terms within rtol {rtol}; "
                f"gradients against the plain path, worst norm-wise {gap!r}")
        if "bf16 off" in runs:
            off = max(_norm_err(runs["bf16 off"][1][n], gp[n]) for n in names)
            line += f" (limit {GHOST_BF16_STEP}; bf16 off {off!r})"
            if not gap <= GHOST_BF16_STEP < off:
                raise AssertionError(f"{tag}: step gradients {gap}, {off}")
        log("bf16", line)
        net_s, state, step = _bf16_step(torch, classifier, **cfg)
        reset_launch_counts()
        losses = [step(state, xt, y)["loss"] for _ in range(BF16_STEPS)]
        torch.cuda.synchronize()
        counts = launch_counts()
        losses = [float(v) for v in losses]
        if not all(np.isfinite(losses)) \
                or any(counts.get(k, 0) < 1 for k in need) \
                or any(counts.get(k, 0) for k in absent):
            raise AssertionError(f"{tag}: losses {losses}, launches {counts}")
        log("bf16", f"{BF16_STEPS} steps, {tag}: losses {losses}; kernel "
                    f"launches {counts}")
        main[tag] = counts
        del net_s, state, step
        torch.cuda.empty_cache()
    return {"point_mlp_max_bf16": main["eval"]["point_mlp_max_bf16"],
            **{k: main["exact chain in bf16"][k]
               for k in ("point_mlp_exact_bf16_fwd",
                         "point_mlp_exact_bf16_bwd")}}


def phase_bf16_cli(torch) -> None:
    """train_classifier --bf16 on procedural data for one epoch of 3 steps,
    then train_samplenet --bf16 against its checkpoint for one epoch of 2:
    both exit 0, log an accuracy and publish f32 weights."""
    base = ["--device", "cuda", "--dataset", "procedural", "--epochs", "1",
            "--train-size", "128", "--test-size", "64", "--seed", str(SEED),
            "--bf16"]
    with tempfile.TemporaryDirectory() as tmp:
        cls_dir, sn_dir = os.path.join(tmp, "cls"), os.path.join(tmp, "sn")
        out1, s1 = _cli(["samplenet_tpu_torch.train.train_classifier", *base,
                         "--steps-per-epoch", "3", "--log-dir", cls_dir],
                        "train_classifier --bf16")
        out2, s2 = _cli(["samplenet_tpu_torch.train.train_samplenet", *base,
                         "--steps-per-epoch", "2", "--classifier-ckpt",
                         os.path.join(cls_dir, "ckpt"), "--log-dir", sn_dir],
                        "train_samplenet --bf16")
        for d, f in ((cls_dir, "classifier.pth"), (sn_dir, "sampler.pth")):
            sd = torch.load(os.path.join(d, "ckpt", f), weights_only=True)
            if {t.dtype for k, t in sd.items()
                    if not k.endswith("num_batches_tracked")} \
                    != {torch.float32}:
                raise AssertionError(f"{d}: weights not f32")
    if "test_acc=" not in out1 or "eval_acc@32=" not in out2:
        raise AssertionError(f"the bf16 CLIs logged:\n{out1}\n{out2}")
    log("bf16-cli", f"train_classifier --bf16: exit 0 in {s1:.1f} s; "
                    f"train_samplenet --bf16 --classifier-ckpt: exit 0 in "
                    f"{s2:.1f} s; both published f32 weights")


def phase_times_bf16(torch, model, clouds, data, labels, classifier,
                     card) -> dict[str, tuple]:
    """The bf16 modes against their plain bf16 versions: CUDA-event time per
    call (plain, kernel, kernel, plain) and profiler device time, at the
    classification step's shape (the exact chain's forward, and its
    backward on a saved forward state) and at the eval shapes B=1024 and
    B=32 (point_mlp_max); beside the f32 kernels in the same call; the
    eval forward with hard matching at B=1024 with eval_bf16 against the
    f32 kernel path (f32, bf16, bf16, f32); and the classification
    sampler step with the exact chain in bf16 and with the compute dtype,
    per step and device time."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain

    x = torch.from_numpy(clouds).to(DEVICE)
    net = _eval_bf16_model(torch, model)
    with torch.inference_mode():
        ms16, ms32 = _pair_ms(torch, lambda: net(x), lambda: model(x), 10)
        dev16 = _device_ms(torch, lambda: net(x), 5)
        dev32 = _device_ms(torch, lambda: model(x), 5)
    log("times-bf16", f"eval forward + matching at B={B} with eval_bf16: "
                      f"{ms16!r} ms per call, device {dev16!r} (busy "
                      f"{dev16 / ms16!r}); the f32 kernel path {ms32!r}, "
                      f"device {dev32!r} ({card})")
    del net
    xt = torch.from_numpy(data).to(DEVICE)
    y = torch.from_numpy(labels).to(DEVICE)
    for tag, cfg in (("exact chain in bf16", dict(
            fused_train=True, fused_mode="exact", fused_bf16=True)),
                     ("compute dtype bf16", dict(bf16=True)),
                     ("f32 (the default)", {})):
        _, state, step = _bf16_step(torch, classifier, **cfg)
        ms = _time_ms(torch, lambda: step(state, xt, y), 3, warmup=1)
        dev = _device_ms(torch, lambda: step(state, xt, y), 2)
        log("times-bf16", f"cls sampler step at B={B}, {tag}: {ms!r} ms, "
                          f"device {dev!r} (busy {dev / ms!r}) ({card})")
        del state, step
        torch.cuda.empty_cache()
    times = {}
    rng = np.random.default_rng(SEED + 41)
    for b in (B, REG_B):
        x = _randn(torch, rng, b, N, 3)
        wbs = []
        for cin, cout in zip(WIDTHS[:-1], WIDTHS[1:]):
            wbs += [_randn(torch, rng, cin, cout) / cin ** 0.5,
                    0.1 * _randn(torch, rng, cout)]
        with torch.no_grad():
            fns = {"kernel": lambda: point_mlp_max(x, wbs, bf16=True),
                   "plain": lambda: point_mlp_max_plain(x, wbs, True),
                   "f32 kernel": lambda: point_mlp_max(x, wbs)}
            ms, plain_ms = _pair_ms(torch, fns["kernel"], fns["plain"], 20)
            dev = {k: _device_ms(torch, f, 10) for k, f in fns.items()}
            f32_ms = _time_ms(torch, fns["f32 kernel"], 20)
        log("times-bf16", f"point_mlp_max bf16 at B={b}: {ms!r} ms per call, "
                          f"device {dev['kernel']!r} (plain bf16 "
                          f"{plain_ms!r}, device {dev['plain']!r}; the f32 "
                          f"kernel {f32_ms!r}, device {dev['f32 kernel']!r}) "
                          f"({card})")
        if b == B:
            times["point_mlp_max_bf16"] = (ms, plain_ms)
    x, groups, g = _exact_inputs(torch, rng, B, N)
    weights, _, gammas, betas = groups
    saved = pme.point_mlp_exact_fwd_cuda(x, weights, gammas, betas, 1e-5,
                                         True)[3]
    zs, mus, rstds, argmax = saved
    saved_p = (zs, mus, rstds, argmax.long())
    for name, kfn, pfn in (
            ("point_mlp_exact_bf16_fwd",
             lambda: pme.point_mlp_exact_fwd_cuda(x, weights, gammas, betas,
                                                  1e-5, True),
             lambda: pme.point_mlp_exact_fwd_plain(x, weights, gammas, betas,
                                                   1e-5, True)),
            ("point_mlp_exact_bf16_bwd",
             lambda: pme.point_mlp_exact_bwd_cuda(x, weights, gammas, betas,
                                                  saved, g, True),
             lambda: pme.point_mlp_exact_bwd_plain(x, weights, gammas, betas,
                                                   saved_p, g, True))):
        ms, plain_ms = _pair_ms(torch, kfn, pfn, 5)
        dk, dp = _device_ms(torch, kfn, 3), _device_ms(torch, pfn, 3)
        log("times-bf16", f"{name} at B={B}: {ms!r} ms per call, device "
                          f"{dk!r} (plain bf16 {plain_ms!r}, device {dp!r}) "
                          f"({card})")
        times[name] = (ms, plain_ms)
    torch.cuda.empty_cache()
    return times


# -------------------------------------------------------------- the bounds

def _bound(nbytes: float, *ops: tuple[float, float]) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and each type's operations over that type's peak rate; an
    operations bound names its type, as "operations (TF32)"."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops, rate = max((count / rate, rate) for count, rate in ops)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops
            else f"operations ({RATE_NAMES[rate]})")


def _exact_bounds(b: int, n: int, widths) -> tuple[tuple, tuple]:
    """Bounds of the exact-BN chain's forward and backward over B*N points:
    2 (forward) or 4 (backward: dW and dh) FLOP per multiply-add, and BN,
    ReLU and statistics per channel, on FP32; x and the parameters in, the
    pooled features and statistics (forward) or dx and the parameters'
    gradients (backward) out."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = sum(a * c for a, c in pairs)
    params = sum(a * c + 4 * c for a, c in pairs)
    chans = sum(widths[1:])
    p, f = b * n, 4
    return (_bound(f * (p * widths[0] + params + b * widths[-1] + 2 * chans),
                   (p * (2.0 * macs + 7 * chans), FP32_FLOP_PER_S)),
            _bound(f * (2 * p * widths[0] + 2 * params + b * widths[-1]),
                   (p * (4.0 * macs + 12 * chans), FP32_FLOP_PER_S)))


def _nn_bound(b: int, nq: int, nd: int,
              snap: bool = False) -> tuple[float, str]:
    """1-NN of nq queries among nd points: 3 sub, 3 mul, 2 add and 1
    compare a pair; the queries and points in, a distance and an index a
    query out (and with `snap` the neighbour's 3 floats)."""
    return _bound(4 * (b * nq * 3 + b * nd * 3 + (5 if snap else 2) * b * nq),
                  (9.0 * b * nq * nd, FP32_FLOP_PER_S))


def _soft_fwd_bound(b: int, n: int, m: int, k: int) -> tuple[float, str]:
    """The soft projection's forward: M queries against N points, 3 sub, 3
    mul, 2 add and 1 compare a pair, and about 20 FLOP a neighbour for its
    weight and the weighted sum; the points, queries and sigma in, out and
    idx out."""
    return _bound(4 * (b * n * 3 + 2 * b * m * 3 + b * m * k + 1),
                  (9.0 * b * m * n + 20.0 * b * m * k, FP32_FLOP_PER_S))


def _soft_bwd_bound(b: int, n: int, m: int, k: int,
                    gathered: int | None = None) -> tuple[float, str]:
    """The soft projection's backward: the `gathered` points that idx
    names read (all clouds together; by default the most it can name,
    min(N, M*k) a cloud) and d points written whole, the queries, the
    cotangent and d queries, idx, sigma^2 and d sigma^2; about 40 FLOP a
    neighbour (its distance, weight, d queries, d sigma^2 term and
    contribution to d points)."""
    if gathered is None:
        gathered = b * min(n, m * k)
    return _bound(4 * (3 * gathered + b * n * 3 + 3 * b * m * 3 + b * m * k
                       + 2),
                  (40.0 * b * m * k, FP32_FLOP_PER_S))


def _gathered(torch, idx, n: int) -> int:
    """The distinct (cloud, point) pairs that idx [B, M, k] names: the
    points the backward must read."""
    b = idx.shape[0]
    offset = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    return int((idx.to(torch.int64) + offset[:, None, None]).unique().numel())


def _fps_bound(b: int, n: int, m: int) -> tuple[float, str]:
    """FPS: M picks, each updating N min-distances (3 sub, 3 mul, 2 add,
    1 min) and an argmax (1 compare); the points, given indices and counts
    in, idx and xyz out."""
    return _bound(4 * (b * n * 3 + b * m * 2 + b + b * m * 3),
                  (10.0 * b * m * n, FP32_FLOP_PER_S))


def _emd_bound(b: int, n: int, m: int) -> tuple[float, str]:
    """What the function needs, each level's arithmetic once per pair (an
    FMA counts 2 FLOP): d2 (8 FLOP) and one rsqrt giving d and 1/d (1 SFU
    op, 1 FLOP) per pair; per pair and level L != 0 (10 levels), one exp
    (1 SFU op) and 24 FLOP: L * d2, * satr, the row sum, * satl / rowsum,
    the column sum, * ratio, the row sum of the level's mass, the cost
    (FMA), u = wr / d, the sums of u over the row and the column and of u
    times the other cloud's xyz (6 FMA); level 0 needs no exp and no
    product with L or satr (22 FLOP). The clouds in, the cost and both
    gradients out."""
    pairs = b * n * m
    flop = 8 + 1 + 10 * 24 + 22
    return _bound(4 * (2 * b * (n + m) * 3 + b),
                  (flop * float(pairs), FP32_FLOP_PER_S),
                  (11.0 * pairs, SFU_OP_PER_S))


def kernel_bounds(soft_gathered: int | None = None
                  ) -> dict[str, tuple[float, str]]:
    """Each kernel's bound at the shapes its times are taken at (the soft
    projection's backward reading the `soft_gathered` points that its
    timed run's idx names): each
    input read once, each output written once, and the operations the
    algorithm needs on these inputs (FP32 on the SIMT pipes; the EMD's
    exp and rsqrt on the special-function units; on the tensor cores
    point_mlp_max's multiply-adds, as three TF32 products each (held to
    f32), and the ghost chain's, bf16 by default; the bf16 modes' products
    at the BF16 peak)."""
    f = 4                                          # bytes of f32 and i32
    exact_fwd, exact_bwd = _exact_bounds(B, N, WIDTHS)
    ghost_fwd, ghost_bwd = _ghost_bounds(PROG_B, PROG_N, WIDTHS, True)
    exact_bf16_fwd, exact_bf16_bwd = _ghost_bounds(B, N, WIDTHS, True)
    pairs = list(zip(WIDTHS[:-1], WIDTHS[1:]))
    macs = sum(a * c for a, c in pairs)
    params = sum(a * c + c for a, c in pairs)
    return {
        "nn_direction": _nn_bound(B, M, N),
        "fps": _fps_bound(B, N, M),
        "point_mlp_max": _bound(
            f * (B * N * 3 + params + B * WIDTHS[-1]),
            (B * N * 3 * 2.0 * macs, TF32_FLOP_PER_S),
            (B * N * 3.0 * sum(WIDTHS[1:]), FP32_FLOP_PER_S)),
        "point_mlp_exact_fwd": exact_fwd,
        "point_mlp_exact_bwd": exact_bwd,
        "soft_projection_fwd": _soft_fwd_bound(B, N, M, K),
        "soft_projection_bwd": _soft_bwd_bound(B, N, M, K, soft_gathered),
        "emd": _emd_bound(RECON_B, RECON_N, RECON_N),
        "nn_snap": _nn_bound(PROG_B, PROG_N, PROG_N, snap=True),
        "point_mlp_train_fwd": ghost_fwd,
        "point_mlp_train_bwd": ghost_bwd,
        "point_mlp_max_bf16": _bound(
            f * (B * N * 3 + params + B * WIDTHS[-1]),
            (B * N * 2.0 * macs, BF16_FLOP_PER_S),
            (B * N * 3.0 * sum(WIDTHS[1:]), FP32_FLOP_PER_S)),
        "point_mlp_exact_bf16_fwd": exact_bf16_fwd,
        "point_mlp_exact_bf16_bwd": exact_bf16_bwd,
    }


# data parallelism (parallel/): DP_RANKS gloo ranks sharing the card, each
# on its rows of a global batch, against the one-process step on the same
# card and weights: the classification step at B=1024 (augmented), the
# registration sampler step at B=32, the reconstruction sampler step at
# B=50 (EMD), the progressive ghost step at B=32 (bf16, block 4, every
# block within a rank) and at B=28 (block 4 again: 14 clouds a rank, so the
# block of clouds 12-15 straddles the ranks and every block is summed
# from sub-blocks of 2 clouds across them)
DP_RANKS = 2
DP_GHOST = ("progressive ghost", "progressive ghost straddling")
DP_CASES = ("classification", "registration", "reconstruction", *DP_GHOST)
DP_STRADDLE_B = 28
# the ghost cases' gradients against the one-process kernel step (the same
# bf16 roundings), norm-wise: the card read 9.4e-4 (B=32) and 8.5e-4
# (B=28), both at conv1.weight, and 1.38 for the ghost control (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md)
DP_GHOST_LIMIT = 5e-3
DP_PATH = ("point_mlp_exact_fwd", "point_mlp_exact_bwd", "point_mlp_train_fwd",
           "point_mlp_train_bwd", "soft_projection_fwd", "soft_projection_bwd",
           "nn_direction", "emd")
DP_COLLECTIVES = 5 * 2 + 3 * 2 + 1   # a classification step's all-reduces
DP_TIMED = 3                         # classification steps timed a side
_DP_INPUTS: dict = {}


def _dp_inputs(torch) -> dict:
    """The seeded global batches and frozen networks of the data-parallel
    cases, made once a process."""
    if not _DP_INPUTS:
        data, labels, classifier = make_train_setup(torch)
        _DP_INPUTS.update(
            x=torch.from_numpy(data).to(DEVICE),
            y=torch.from_numpy(labels).to(DEVICE), classifier=classifier,
            reg=_reg_data(torch), pcrnet=_reg_pcrnet(torch),
            ae=_recon_state(torch, "ae")[0],
            recon_x=make_recon_data(torch)[1])
    return _DP_INPUTS


def _dp_setup(torch, case, *, dtype=None):
    """(model, state, step, args, extra) of `case`: a seeded state, its
    step and the global batch (in `dtype` where given); extra() gives the
    step's generator."""
    inp = _dp_inputs(torch)
    cast = (lambda t: t) if dtype is None else \
        (lambda t: t.to(dtype) if t.is_floating_point() else t)
    extra = lambda: ()                                       # noqa: E731
    if case == "classification":
        model, state, step = _train_step(torch, inp["classifier"],
                                         dtype=dtype, augment=True)
        args = [inp["x"], inp["y"]]
        extra = lambda: (torch.Generator(                  # noqa: E731
            device=DEVICE).manual_seed(SEED),)
    elif case == "registration":
        model, state, step = _reg_state(torch, "sampler", dtype=dtype,
                                        pcrnet=inp["pcrnet"])
        args = list(inp["reg"])
    elif case == "reconstruction":
        model, state, step = _recon_state(torch, "sampler", inp["ae"],
                                          dtype=dtype)
        args = [inp["recon_x"]]
    else:
        model, state, step = _prog_step(torch, inp["classifier"], ghost=True,
                                        dtype=dtype)
        b = PROG_B if case == "progressive ghost" else DP_STRADDLE_B
        args = [inp["x"][:b], inp["y"][:b]]
    return model, state, step, [cast(t) for t in args], extra


def _dp_result(torch, model, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters() if p.grad is not None},
            "ema": {k: v.detach().cpu() for k, v in model.named_buffers()
                    if "running_" in k}}


@contextlib.contextmanager
def _blocks_unsummed(torch):
    """The ghost chain's blocks with their all-reduce skipped: a block that
    straddles the ranks takes its statistics (forward and backward) from
    one rank's rows only."""
    from samplenet_tpu_torch.parallel.mesh import Blocks

    real = Blocks.sums, Blocks.global_means
    Blocks.sums = lambda self, t: t
    Blocks.global_means = lambda self, rows: [
        r.sum(0) / (self.ranks * r.shape[0]) for r in rows]
    try:
        yield
    finally:
        Blocks.sums, Blocks.global_means = real


def _dp_rank(mesh, ckpt: str) -> dict:
    """One of DP_RANKS ranks: each case's step on its rows (the launch
    counters around them), the per-rank-BN control and the ghost control,
    the classification step's time, its collectives, and save_sharded of
    its state."""
    import torch

    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.parallel.mesh import (
        collective_counts,
        data_parallel,
        global_mean,
        reset_collective_counts,
        shard_batch,
    )
    from samplenet_tpu_torch.train import checkpoints

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}
    reset_launch_counts()
    for case in DP_CASES:
        model, state, step, args, extra = _dp_setup(torch, case)
        data_parallel(state, mesh)
        made: list = []
        rec = choices(torch, record=made) if case == "registration" \
            else contextlib.nullcontext()
        with rec:
            metrics = global_mean(step(state, *shard_batch(mesh, args),
                                       *extra()), mesh)
        torch.cuda.synchronize()
        out[case] = _dp_result(torch, model, metrics)
        out[case]["choices"] = [t.cpu() for t in made]
        if case == "classification":
            checkpoints.save_sharded(ckpt, {
                "model": model.state_dict(),
                "step": torch.tensor(state.step)})
            out["saved"] = {k: v.cpu() for k, v in
                            model.state_dict().items()}
        del model, state, step
    out["launches"] = launch_counts()

    model, state, step, args, extra = _dp_setup(torch, "classification")
    data_parallel(state, mesh)
    data_parallel(model, None)      # the control: statistics per rank
    step(state, *shard_batch(mesh, args), *extra())
    out["control"] = _dp_result(torch, model, {})

    model, state, step, args, extra = _dp_setup(torch, DP_GHOST[1])
    data_parallel(state, mesh)
    with _blocks_unsummed(torch):
        step(state, *shard_batch(mesh, args), *extra())
    out["ghost control"] = _dp_result(torch, model, {})

    model, state, step, args, extra = _dp_setup(torch, "classification")
    data_parallel(state, mesh)
    rows, gen = shard_batch(mesh, args), extra()
    step(state, *rows, *gen)
    torch.cuda.synchronize()
    reset_collective_counts()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        step(state, *rows, *gen)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) / DP_TIMED * 1e3
    out["collectives"] = {k: v // DP_TIMED for k, v in
                          collective_counts().items()}
    return out


def _dp_reference(torch, case, ranks) -> dict:
    """The one-process steps of `case` on the card: the kernel path, the
    float64 plain path (for the ghost cases with bf16 off at the same
    block: it only tells which gradients are zero in exact arithmetic)
    and but for the ghost cases the plain f32 path (for the registration
    step also the replays of the ranks' choices and of the plain
    path's)."""
    f64 = torch.float64
    runs = {}
    variants = [("kernel", False, None), ("f64", True, f64)]
    if case not in DP_GHOST:
        variants.append(("plain", True, None))
    for name, plain, dtype in variants:
        model, state, step, args, extra = _dp_setup(torch, case, dtype=dtype)
        made: list = []
        how = contextlib.nullcontext()
        if case == "registration" and dtype is None:
            how = choices(torch, record=made)
        if case in DP_GHOST and name == "f64":
            how = _ghost_without_rounding(torch)
        with _ctx(plain), how:
            metrics = step(state, *args, *extra())
        torch.cuda.synchronize()
        runs[name] = _dp_result(torch, model, metrics)
        runs[name]["choices"] = made
        del model, state, step
    if case == "registration":
        ranks_made = [torch.cat([r[case]["choices"][i].to(DEVICE)
                                 for r in ranks])
                      for i in range(len(ranks[0][case]["choices"]))]
        runs["apart"] = sum(int((a != c).sum()) for a, c in zip(
            ranks_made, runs["kernel"]["choices"]))
        for name, made in (("plain f64 replay", runs["plain"]["choices"]),
                           ("ranks f64 replay", ranks_made)):
            model, state, step, args, _ = _dp_setup(torch, case, dtype=f64)
            with _ctx(True), choices(torch, replay=made):
                metrics = step(state, *args)
            torch.cuda.synchronize()
            runs[name] = _dp_result(torch, model, metrics)
            del model, state, step
    return runs


def _dp_grads_check(case, got, runs, kind=None,
                    kernel_too=False) -> tuple[float, float, str]:
    """The ranks' gradients against the float64 one-process step: each at
    most twice the plain f32 one-process step's error (by the largest
    entry over the f64 scale, or norm-wise where the card checks of the
    track hold it so, with their floors). The ghost cases, whose bf16
    roundings no f64 step has, against the one-process kernel step, which
    rounds alike: norm-wise within DP_GHOST_LIMIT. Gradients zero in exact
    arithmetic round-off. `kind` names the DP case whose rule another
    step follows (the tensor-parallel phase's); with `kernel_too` the
    ranks may also reach twice the one-process kernel step's error.
    Returns the worst (ranks, plain (or kernel) or limit, name)."""
    kind = case if kind is None else kind
    ghost = kind in DP_GHOST
    exact = runs["ranks f64 replay" if kind == "registration" else "f64"]
    ref = runs["kernel"] if ghost else exact
    plain_ref = None if ghost else runs[
        "plain f64 replay" if kind == "registration" else "f64"]
    err = _rel_err if kind == "classification" else _norm_err
    floor = 1e-5 if kind == "classification" else 1e-4
    scale = max(float(g.abs().max()) for g in exact["grads"].values())
    worst = (0.0, 0.0, "")
    for name, g in got.items():
        r = ref["grads"][name]
        # zero in exact arithmetic: a dense bias before a BN, and the last
        # conv BN's beta where no pooled feature of the batch is clipped
        # (with augmentation some are, and its f64 gradient is 1e-3 of
        # scale: NVIDIA H100, PERF.md)
        if float(exact["grads"][name].abs().max()) <= 1e-8 * scale:
            if float(g.abs().max()) > 1e-4 * scale:
                raise AssertionError(
                    f"ranks' {case} {name}: gradient "
                    f"{float(g.abs().max())!r} not round-off (scale "
                    f"{scale!r})")
            continue
        ek = err(g, r)
        if ghost:
            ep = DP_GHOST_LIMIT
            if not ek <= ep:
                raise AssertionError(
                    f"ranks' {case} {name}: error {ek!r} "
                    f"against the one-process kernel step, limit {ep!r}")
            worst = max(worst, (ek, ep, name))
            continue
        ep = err(runs["plain"]["grads"][name], plain_ref["grads"][name])
        if kernel_too:
            ep = max(ep, err(runs["kernel"]["grads"][name], exact["grads"][
                name]))
        if not ek <= max(2 * ep, floor):
            raise AssertionError(f"ranks' {case} {name}: error {ek!r} "
                                 f"against f64, the one-process plain f32 "
                                 f"step's {ep!r}")
        worst = max(worst, (ek, ep, name))
    return worst


def phase_data_parallel(torch, classifier) -> None:
    """DP_RANKS gloo ranks on the card against the one-process step, the
    per-rank-BN control, the sharded checkpoint restored here and trained
    one more step, and train_samplenet --data-parallel under torchrun over
    NCCL (one rank a card)."""
    from samplenet_tpu_torch.parallel.dryrun import dryrun_multichip
    from samplenet_tpu_torch.parallel.launch import spawn
    from samplenet_tpu_torch.train import checkpoints

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sharded")
        t0 = time.monotonic()
        ranks = spawn(_dp_rank, DP_RANKS, ckpt, device=DEVICE, timeout=300.0)
        spawn_s = time.monotonic() - t0
        for r, out in enumerate(ranks):
            missing = [k for k in DP_PATH if out["launches"].get(k, 0) < 1]
            if missing:
                raise AssertionError(f"rank {r} launched no {missing}")
            if out["collectives"]["all_reduce"] != DP_COLLECTIVES:
                raise AssertionError(f"rank {r}: a classification step "
                                     f"issued {out['collectives']} "
                                     f"all-reduces, not {DP_COLLECTIVES}")
        notes = []
        for case in DP_CASES:
            runs = _dp_reference(torch, case, ranks)
            kernel = runs["kernel"]
            # the registration step's discrete choices (k=8 neighbours, the
            # 1-NN, PCRNet's masks) move on near-ties between any two f32
            # runs (PERF.md): its loss terms are held, as its card
            # check holds them, to the f64 replay of the ranks' own choices
            ref, rtol = (runs["ranks f64 replay"], 1e-4) \
                if case == "registration" else (kernel, 1e-5)
            for r, out in enumerate(ranks):
                got = out[case]
                for k, v in ref["metrics"].items():
                    if not (np.isfinite(got["metrics"][k]) and np.isclose(
                            got["metrics"][k], v, rtol=rtol, atol=0)):
                        raise AssertionError(
                            f"data-parallel {case} rank {r} {k}: "
                            f"{got['metrics'][k]!r}, reference {v!r}")
                for k, v in kernel["ema"].items():
                    torch.testing.assert_close(got["ema"][k], v, rtol=1e-4,
                                               atol=1e-6)
                worst = _dp_grads_check(case, got["grads"], runs)
            apart = "" if case != "registration" else (
                f", f64 replay of the ranks' choices "
                f"{ref['metrics']['loss']!r}; choices apart from the "
                f"one-process step's: {runs['apart']}")
            against = ("the one-process kernel step", "limit") \
                if case in DP_GHOST else ("f64", "one-process plain f32")
            notes.append(f"{case}: loss {ranks[0][case]['metrics']['loss']!r}"
                         f" (one process {kernel['metrics']['loss']!r}"
                         f"{apart}), worst gradient error against "
                         f"{against[0]} {worst[0]!r} at {worst[2]} "
                         f"({against[1]} {worst[1]!r})")
            if case == "classification":
                cls_runs = runs
            if case == DP_GHOST[1]:
                ghost_runs = runs
            torch.cuda.empty_cache()
        try:
            _dp_grads_check("classification", ranks[0]["control"]["grads"],
                            cls_runs)
        except AssertionError as e:
            control = str(e)
        else:
            raise AssertionError("the per-rank-BN control passed the "
                                 "gradient check")
        try:
            _dp_grads_check(DP_GHOST[1], ranks[0]["ghost control"]["grads"],
                            ghost_runs)
        except AssertionError as e:
            ghost_control = str(e)
        else:
            raise AssertionError("the ghost control (the straddling block's "
                                 "all-reduce skipped) passed the gradient "
                                 "check")
        t0 = time.monotonic()
        dryrun_multichip(DP_RANKS)
        dryrun_s = time.monotonic() - t0

        model, state, step, args, extra = _dp_setup(torch, "classification")
        target = {"model": model.state_dict(), "step": torch.tensor(0)}
        checkpoints.restore_sharded(ckpt, target)
        for k, v in ranks[0]["saved"].items():
            if not torch.equal(model.state_dict()[k].cpu(), v):
                raise AssertionError(f"restore_sharded: {k} differs")
        state.step = int(target["step"])
        loss = float(step(state, *args, *extra())["loss"])
        if not np.isfinite(loss) or state.step != 2:
            raise AssertionError(f"step after restore_sharded: loss {loss}, "
                                 f"step {state.step}")

        t0 = time.monotonic()
        model, state, step, args, extra = _dp_setup(torch, "classification")
        step(state, *args, *extra())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(DP_TIMED):
            step(state, *args, *extra())
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) / DP_TIMED * 1e3

        cls_path = os.path.join(tmp, "classifier.pth")
        torch.save({k: v.cpu() for k, v in classifier.state_dict().items()},
                   cls_path)
        k = min(torch.cuda.device_count(), 2)
        log_dir = os.path.join(tmp, "log")
        stdout, cli_s = _cli([
            "torch.distributed.run", "--standalone",
            f"--nproc-per-node={k}", "-m",
            "samplenet_tpu_torch.train.train_samplenet", "--data-parallel",
            "--device", "cuda", "--epochs", "1", "--steps-per-epoch", "2",
            "--train-size", "64", "--test-size", "32",
            "--classifier-weights", cls_path, "--log-dir", log_dir],
            "torchrun train_samplenet --data-parallel")
        if f"data-parallel over {k} ranks" not in stdout or not \
                os.path.exists(os.path.join(log_dir, "ckpt", "sampler.pth")):
            raise AssertionError(f"torchrun train_samplenet: {stdout}")
    log("data-parallel", f"{DP_RANKS} gloo ranks on one card (gloo stages "
                         f"its all-reduces through the host), each on its "
                         f"rows of the global batch, against the "
                         f"one-process step: "
                         + "; ".join(notes) + "; loss terms within rtol "
                         "1e-5 of the one-process step's (registration: "
                         "1e-4 of the f64 replay of the ranks' choices), "
                         "running statistics rtol 1e-4 / atol 1e-6")
    log("data-parallel", f"each rank launched {sorted(DP_PATH)}: "
                         f"{[{k: r['launches'].get(k, 0) for k in DP_PATH} for r in ranks]}")
    log("data-parallel", f"the per-rank-BN control fails the gradient "
                         f"check: {control}")
    log("data-parallel", f"the ghost control (at B={DP_STRADDLE_B}, the "
                         f"all-reduce of the blocks skipped, so the block "
                         f"straddling the ranks takes one rank's rows) "
                         f"fails the gradient check: {ghost_control}")
    log("data-parallel", f"dryrun_multichip({DP_RANKS}) on the card (gloo "
                         f"ranks sharing it): every track finite and equal "
                         f"on every rank in {dryrun_s:.1f} s")
    log("data-parallel", f"a classification step at B={B} issues "
                         f"{ranks[0]['collectives']['all_reduce']} "
                         f"all-reduces ({ranks[0]['collectives']['bytes']} "
                         f"bytes) a rank; its wall time a step "
                         f"{[round(r['step_ms'], 3) for r in ranks]} ms on "
                         f"the {DP_RANKS} ranks sharing the card, host-staged "
                         f"gloo, no measure of scaling (one process: "
                         f"{one_ms:.3f} ms); the ranks took {spawn_s:.1f} s "
                         f"from spawn to results")
    log("data-parallel", f"save_sharded from {DP_RANKS} ranks, "
                         f"restore_sharded here bit for bit, one more step: "
                         f"loss {loss!r}; torchrun --nproc-per-node={k} "
                         f"train_samplenet --data-parallel over NCCL: exit 0 "
                         f"in {cli_s:.1f} s")


# tensor parallelism (parallel/mesh.py): steps whose task network has
# layers of 512 or more outputs, those layers sharded over 'model'
TP_CASES = {(1, 2): ("classifier", "pcrnet", "ae", "wide sampler"),
            (2, 2): ("classifier",)}
# the data-parallel case whose gradient rule each step follows (PCRNet's
# against the f64 replay of the ranks' choices, `choices`); the
# classifier step's gradients are held in float64 instead (TP_F64): in f32
# its conv layers' gradients carry the round-off of the BatchNorms'
# per-channel reductions over all 32768 points (one outer product:
# tools/diagnostics/classifier_step_meshes.py), whose size follows the
# order those reductions add in: conv1's 1.4e-3 of scale on one process,
# 1.7e-6 on 1 x 2, 2.7e-3 on 2 x 2 (NVIDIA H100, PERF.md), so no f32
# rule decides; the wide sampler's
# ranks are held to twice the larger of the one-process plain f32 and
# kernel steps' errors against f64: at B=32 the plain step sits 3e-6 from
# f64 (NVIDIA H100, PERF.md), and the exact-BN kernel's own choices (ReLU
# masks and max-pool argmaxes inside it, which no replay reaches) move
# the kernel path's gradient apart from f64's in one process as well
TP_RULE = {"classifier": None, "wide sampler": "classification",
           "pcrnet": "registration", "ae": "reconstruction"}
TP_KERNEL_TOO = ("wide sampler",)
TP_F64 = ("classifier",)        # also run in float64, held to 1e-10
TP_SHARDED = {"classifier": ["conv5", "bn5", "fc1", "bn_fc1"],
              "pcrnet": ["feat.conv5", "fc1", "fc2", "fc3", "fc4"],
              "ae": ["dec_out"], "wide sampler": ["conv5", "bn5", "fc4"]}
# the kernels each step launches on every rank: the classifier's chains run
# without pool_max, as tensor ops (the JAX package's XLA chain), so its step
# launches none
TP_PATH = {"classifier": (), "pcrnet": ("nn_direction",),
           "ae": ("point_mlp_exact_fwd", "point_mlp_exact_bwd", "emd"),
           "wide sampler": ("point_mlp_exact_fwd", "point_mlp_exact_bwd",
                            "soft_projection_fwd", "soft_projection_bwd",
                            "nn_direction")}
TP_EVAL_PATH = ("point_mlp_max", "nn_direction", "fps")
# (all-reduces, all-gathers) of one step, predicted from the code. Over the
# model axis: every sharded layer's output block is gathered once (conv5's
# argmax and max of the classifier twice; conv5 of PCRNet once per cloud;
# the wide sampler's exact chain gathers conv5's kernel and bias and bn5's
# gamma and beta, and fc4's output once), every column-parallel layer's
# copy sums its input's cotangent once (the chain's gathered weights need
# none), and the optimiser agrees on its flag over the world once. Over
# the data axis (2 x 2): each of the classifier's 7 BatchNorms sums its
# statistics forward and their cotangent backward, and the optimiser
# averages the gradients once.
TP_COLLECTIVES = {("classifier", 1, 2): (2 + 1, 3),
                  ("classifier", 2, 2): (7 * 2 + 1 + 2 + 1, 3),
                  ("pcrnet", 1, 2): (2 + 4 + 1, 2 + 4),
                  ("ae", 1, 2): (1 + 1, 1),
                  ("wide sampler", 1, 2): (1 + 1, 4 + 1)}
TP_WIDE_M, TP_WIDE_BOTTLENECK = 256, 512


def _tp_setup(torch, case, *, dtype=None):
    """(model, state, step, args, extra) of a tensor-parallel case at full
    width: a seeded state, its step and the global batch (in `dtype` where
    given; extra() gives the step's generators)."""
    from samplenet_tpu_torch.train import classification as cls

    inp = _dp_inputs(torch)
    cast = (lambda t: t) if dtype is None else \
        (lambda t: t.to(dtype) if t.is_floating_point() else t)
    extra = lambda: ()                                       # noqa: E731
    x, y = inp["x"][:CLS_B], inp["y"][:CLS_B]
    if case == "classifier":
        cfg = cls.ClassifierConfig(num_classes=NUM_CLASSES, batch_size=CLS_B)
        model, state = cls.create_classifier_state(cfg, device=DEVICE,
                                                   seed=SEED + 41)
        step = cls.make_classifier_train_step(model, cfg)
        args = [x, y]
        extra = lambda: tuple(torch.Generator(  # noqa: E731
            device=DEVICE).manual_seed(SEED + i) for i in (42, 43))
    elif case == "pcrnet":
        model, state, step = _reg_state(torch, "pcrnet")
        args = list(inp["reg"])
    elif case == "ae":
        model, state, step = _recon_state(torch, "ae")
        args = [inp["recon_x"]]
    else:
        cfg = cls.SampleNetConfig(num_out_points=TP_WIDE_M,
                                  bottleneck_size=TP_WIDE_BOTTLENECK,
                                  group_size=K, batch_size=CLS_B)
        model, state = cls.create_samplenet_state(cfg, device=DEVICE,
                                                  seed=SEED + 44)
        frozen = inp["classifier"] if dtype is None \
            else copy.deepcopy(inp["classifier"]).to(dtype)
        step = cls.make_samplenet_train_step(model, frozen, cfg)
        args = [x, y]
        extra = lambda: (torch.Generator(  # noqa: E731
            device=DEVICE).manual_seed(SEED + 45),)
    if dtype is not None:
        model.to(dtype)           # in place: the optimiser keeps its params
    return model, state, step, [cast(t) for t in args], extra


def _tp_metrics(metrics) -> dict:
    """A step's metrics as a dict: a classifier step's (loss, acc), an AE
    step's loss, or the dict the other steps return."""
    if isinstance(metrics, dict):
        return dict(metrics)
    if isinstance(metrics, tuple):
        return {"loss": metrics[0], "acc": metrics[1]}
    return {"loss": metrics}


def _tp_result(torch, model, metrics) -> dict:
    """A step's metrics, whole gradients and running statistics (gathered
    over the model group where sharded), on the CPU."""
    from samplenet_tpu_torch.parallel.mesh import (
        full_gradients,
        full_state_dict,
    )

    return {"metrics": {k: float(v) for k, v in
                        _tp_metrics(metrics).items()},
            "grads": {k: g.detach().cpu() for k, g in
                      full_gradients(model).items()},
            "ema": {k: v.detach().cpu() for k, v in
                    full_state_dict(model).items() if "running_" in k}}


def _tp_case(torch, mesh, case, *, dtype=None, bn_mesh=None,
             copy_reduces=True) -> dict:
    """One rank's step of `case` on its rows (in `dtype` where given), its
    wide layers sharded: the result, the launches and collectives of the
    step, and (under the registration rule) its discrete choices.
    `bn_mesh` puts the BatchNorms under another mesh and
    `copy_reduces=False` skips copy-to-region's all-reduce: the
    controls."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.parallel import mesh as mesh_lib

    model, state, step, args, extra = _tp_setup(torch, case, dtype=dtype)
    mesh_lib.shard_params(mesh, mesh_lib.data_parallel(state, mesh))
    if bn_mesh is not None:
        mesh_lib.data_parallel(model, bn_mesh)
    out = {}
    if case == "wide sampler" and dtype is None:  # the eval, before the step
        from samplenet_tpu_torch.ops.matching import nn_match_from_clouds

        x = mesh_lib.shard_batch(mesh, args[0])
        reset_launch_counts()
        with torch.no_grad():
            simp, matched = model(x)
            torch.cuda.synchronize()
            out["eval launches"] = launch_counts()
            with _ctx(True):
                plain_matched, _ = nn_match_from_clouds(x, simp, TP_WIDE_M)
        out["eval"] = (simp.cpu(), bool(torch.equal(matched,
                                                    plain_matched)))
    made: list = []
    rec = choices(torch, record=made) if TP_RULE[case] == "registration" \
        else contextlib.nullcontext()
    real = mesh_lib._CopyToModel.backward
    if not copy_reduces:
        mesh_lib._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))
    torch.cuda.synchronize()
    reset_launch_counts()
    mesh_lib.reset_collective_counts()
    try:
        with rec:
            metrics = step(state, *mesh_lib.shard_batch(mesh, args), *extra())
        torch.cuda.synchronize()
    finally:
        mesh_lib._CopyToModel.backward = real
    counts = mesh_lib.collective_counts()
    launches = launch_counts()
    out.update(_tp_result(torch, model, mesh_lib.global_mean(
        _tp_metrics(metrics), mesh)))
    out.update(launches=launches, choices=[t.cpu() for t in made],
               collectives=(counts.get("all_reduce", 0),
                            counts.get("all_gather", 0)),
               sharded=[n for n, _ in mesh_lib.sharded_modules(model)])
    return out


def _tp_rank(mesh) -> dict:
    """One rank of a D x M mesh: every case of TP_CASES (those of TP_F64
    also in float64), and on 2 x 2 the two controls on the classifier
    step in float64."""
    import dataclasses

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    f64 = torch.float64
    for case in TP_CASES[(mesh.data_size, mesh.model)]:
        out[case] = _tp_case(torch, mesh, case)
        if case in TP_F64:
            out[f"{case} f64"] = _tp_case(torch, mesh, case, dtype=f64)
        torch.cuda.empty_cache()
    if mesh.data_size > 1:
        out["copy control"] = _tp_case(torch, mesh, "classifier", dtype=f64,
                                       copy_reduces=False)
        out["bn control"] = _tp_case(
            torch, mesh, "classifier", dtype=f64,
            bn_mesh=dataclasses.replace(mesh, data_group=mesh.group))
    return out


def _tp_reference(torch, case, ranks, model) -> dict:
    """The one-process steps of `case` on the card: the kernel path, the
    plain f32 path and the float64 plain path; under the registration
    rule also the f64 replays of the plain path's and of the ranks'
    choices (those of the ranks of model index 0, in data order)."""
    replay = TP_RULE[case] == "registration"
    f64 = torch.float64
    runs = {}
    for name, plain, dtype in (("kernel", False, None), ("f64", True, f64),
                               ("plain", True, None)):
        net, state, step, args, extra = _tp_setup(torch, case, dtype=dtype)
        if case == "wide sampler" and name == "kernel":
            with torch.no_grad():          # the eval forward, before the step
                runs["eval"] = net(args[0])[0].cpu()
        made: list = []
        how = choices(torch, record=made) if replay and dtype is None \
            else contextlib.nullcontext()
        with _ctx(plain), how:
            metrics = step(state, *args, *extra())
        torch.cuda.synchronize()
        runs[name] = _tp_result(torch, net, metrics)
        runs[name]["choices"] = made
        del net, state, step
    if replay:
        lead = ranks[::model]
        ranks_made = [torch.cat([r[case]["choices"][i].to(DEVICE)
                                 for r in lead])
                      for i in range(len(lead[0][case]["choices"]))]
        runs["apart"] = sum(int((a != c).sum()) for a, c in zip(
            ranks_made, runs["kernel"]["choices"]))
        for name, made in (("plain f64 replay", runs["plain"]["choices"]),
                           ("ranks f64 replay", ranks_made)):
            net, state, step, args, extra = _tp_setup(torch, case, dtype=f64)
            with _ctx(True), choices(torch, replay=made):
                metrics = step(state, *args, *extra())
            torch.cuda.synchronize()
            runs[name] = _tp_result(torch, net, metrics)
            del net, state, step
    return runs


def _tp_nccl_rank() -> int:
    """Under torchrun over NCCL, one rank a card (`chip_smoke.py
    --tp-nccl`): the classifier step on a 1 x 2 mesh; prints its loss."""
    import torch

    sys.path.insert(0, HERE)
    from samplenet_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )

    initialize_distributed("cuda")
    mesh = make_mesh(model=2)
    out = _tp_case(torch, mesh, "classifier")
    print(f"tp-nccl rank {mesh.rank} {mesh.shape} loss "
          f"{out['metrics']['loss']!r} collectives {out['collectives']}",
          flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _f64_grads_check(case, got, ref) -> float:
    """Each float64 gradient of the ranks within rtol 1e-10 (atol 1e-10 of
    the tensor's largest entry) of the one-process float64 step's, as the
    CPU tests hold float64; one zero in exact arithmetic (below 1e-12 of
    the largest gradient: a dense bias before a BatchNorm) round-off below
    1e-10 of it. Returns the worst |difference| over the tensor's largest
    entry."""
    scale = max(float(r.abs().max()) for r in ref.values())
    worst = 0.0
    for name, r in ref.items():
        top = float(r.abs().max())
        diff = float((got[name] - r).abs().max())
        if top <= 1e-12 * scale:
            ok = float(got[name].abs().max()) <= 1e-10 * scale
        else:
            ok = bool(((got[name] - r).abs() <= 1e-10 * (r.abs() + top)).all())
            worst = max(worst, diff / top)
        if not ok:
            raise AssertionError(f"{case} {name} in float64: |difference| "
                                 f"{diff!r} over {top!r} (scale {scale!r})")
    return worst


def phase_tensor_parallel(torch) -> None:
    """1 x 2 and 2 x 2 gloo ranks sharing the card against the one-process
    step (TP_CASES), the two controls, the collectives against
    TP_COLLECTIVES, dryrun_multichip(4) (a 2 x 2 mesh), and with two or
    more cards the classifier step under torchrun over NCCL."""
    from samplenet_tpu_torch.parallel.dryrun import dryrun_multichip
    from samplenet_tpu_torch.parallel.launch import spawn

    t0 = time.monotonic()
    meshes = {dm: spawn(_tp_rank, dm[0] * dm[1], device=DEVICE,
                        model=dm[1], timeout=300.0) for dm in TP_CASES}
    spawn_s = time.monotonic() - t0
    notes, refs = [], {}
    for (d, m), ranks in meshes.items():
        for case in TP_CASES[(d, m)]:
            if case not in refs:
                refs[case] = _tp_reference(torch, case, ranks, m)
                torch.cuda.empty_cache()
            runs = refs[case]
            rule = TP_RULE[case]
            ref, rtol = (runs["ranks f64 replay"], 1e-4) \
                if rule == "registration" else (runs["kernel"], 1e-5)
            want = TP_COLLECTIVES[(case, d, m)]
            for r, ranks_out in enumerate(ranks):
                got = ranks_out[case]
                if got["sharded"] != TP_SHARDED[case]:
                    raise AssertionError(f"{d}x{m} {case} rank {r}: sharded "
                                         f"{got['sharded']}")
                missing = [k for k in TP_PATH[case]
                           if got["launches"].get(k, 0) < 1]
                if missing:
                    raise AssertionError(f"{d}x{m} {case} rank {r} launched "
                                         f"no {missing}")
                if got["collectives"] != want:
                    raise AssertionError(
                        f"{d}x{m} {case} rank {r}: (all-reduces, "
                        f"all-gathers) {got['collectives']}, predicted "
                        f"{want}")
                for k, v in ref["metrics"].items():
                    if not (np.isfinite(got["metrics"][k]) and np.isclose(
                            got["metrics"][k], v, rtol=rtol, atol=0)):
                        raise AssertionError(
                            f"{d}x{m} {case} rank {r} {k}: "
                            f"{got['metrics'][k]!r}, reference {v!r}")
                for k, v in runs["kernel"]["ema"].items():
                    torch.testing.assert_close(got["ema"][k], v, rtol=1e-4,
                                               atol=1e-6)
                if case in TP_F64:
                    worst = (_f64_grads_check(
                        f"{d}x{m} {case}", ranks_out[f"{case} f64"]["grads"],
                        runs["f64"]["grads"]), 0.0, "f64")
                else:
                    worst = _dp_grads_check(f"{d}x{m} {case}", got["grads"],
                                            runs, rule, case in TP_KERNEL_TOO)
                if case == "wide sampler":
                    simp, matched_ok = got["eval"]
                    missing = [k for k in TP_EVAL_PATH
                               if got["eval launches"].get(k, 0) < 1]
                    if missing or not matched_ok:
                        raise AssertionError(
                            f"{d}x{m} wide sampler eval rank {r}: launched "
                            f"no {missing}, or its matching differs from "
                            f"the plain path's ({matched_ok})")
                    rows = slice((r // m) * CLS_B // d,
                                 (r // m + 1) * CLS_B // d)
                    torch.testing.assert_close(simp, runs["eval"][rows],
                                               rtol=1e-4, atol=1e-4)
            apart = "" if rule != "registration" else (
                f", f64 replay of the ranks' choices "
                f"{runs['ranks f64 replay']['metrics']['loss']!r}; choices "
                f"apart from the one-process step's: {runs['apart']}")
            against = "plain f32 or kernel" if case in TP_KERNEL_TOO \
                else "plain f32"
            exact = "the f64 replay of its choices" \
                if rule == "registration" else "f64"
            if case in TP_F64:
                f32 = {k: _norm_err(ranks[0][case]["grads"][k],
                                    runs["f64"]["grads"][k])
                       for k in ("conv1.weight", "conv5.weight")}
                grads = (f"gradients in float64 within {worst[0]!r} of one "
                         f"process's (largest difference over the tensor's "
                         f"largest entry; limit 1e-10); in f32, norm-wise "
                         f"against f64, conv1.weight {f32['conv1.weight']!r} "
                         f"and conv5.weight {f32['conv5.weight']!r} (one "
                         f"process: " + ", ".join(
                             f"{k} {_norm_err(runs['plain']['grads'][k], runs['f64']['grads'][k])!r}"
                             for k in f32) + ")")
            else:
                grads = (f"worst gradient error against {exact} "
                         f"{worst[0]!r} at {worst[2]} (one-process {against} "
                         f"{worst[1]!r})")
            notes.append(
                f"{d}x{m} {case}: loss {ranks[0][case]['metrics']['loss']!r}"
                f" (one process {runs['kernel']['metrics']['loss']!r}"
                f"{apart}), {grads}; "
                f"launched {ranks[0][case]['launches']}; (all-reduces, "
                f"all-gathers) a step {ranks[0][case]['collectives']}, "
                f"predicted {want}")
    controls = {}
    for name in ("copy control", "bn control"):
        try:
            _f64_grads_check(f"2x2 classifier, {name},",
                             meshes[(2, 2)][0][name]["grads"],
                             refs["classifier"]["f64"]["grads"])
        except AssertionError as e:
            controls[name] = str(e)
        else:
            raise AssertionError(f"the tensor-parallel {name} passed the "
                                 f"gradient check")
    t0 = time.monotonic()
    dryrun_multichip(4)
    dryrun_s = time.monotonic() - t0
    cards = torch.cuda.device_count()
    if cards >= 2:
        stdout, nccl_s = _cli([
            "torch.distributed.run", "--standalone", "--nproc-per-node=2",
            os.path.join(HERE, "chip_smoke.py"), "--tp-nccl"],
            "torchrun chip_smoke.py --tp-nccl")
        # the two ranks print at once: their lines may run together
        losses = [float(v) for v in re.findall(
            r"tp-nccl rank \d+ .*? loss (\S+) collectives", stdout)]
        want = meshes[(1, 2)][0]["classifier"]["metrics"]["loss"]
        if len(losses) != 2 or not np.allclose(losses, want, rtol=1e-5,
                                               atol=0):
            raise AssertionError(f"torchrun --tp-nccl: {stdout}")
        nccl = (f"torchrun --nproc-per-node=2 over NCCL, 1 x 2, one rank a "
                f"card: the classifier step's loss {losses} (gloo "
                f"{want!r}) in {nccl_s:.1f} s")
    else:
        nccl = (f"torchrun over NCCL at 1 x 2 not run: {cards} card (NCCL "
                f"takes one rank a card)")
    log("tensor-parallel", f"gloo ranks sharing the card on 1 x 2 and 2 x 2 "
                           f"meshes, the wide layers sharded over 'model', "
                           f"against the one-process step: "
                           + "; ".join(notes) + "; loss terms within rtol "
                           "1e-5 of the one-process kernel step's (PCRNet: "
                           "1e-4 of the f64 replay of the ranks' choices), "
                           "running statistics rtol 1e-4 / atol 1e-6")
    log("tensor-parallel", f"the wide sampler's eval forward on 1 x 2 "
                           f"launched {sorted(TP_EVAL_PATH)} on every rank, "
                           f"its hard matching bit-equal to the plain "
                           f"path's on the rank's simplified points, these "
                           f"within 1e-4 of one process's")
    for name, msg in controls.items():
        log("tensor-parallel", f"the {name} ("
            + ("copy-to-region's backward without its all-reduce"
               if name == "copy control" else
               "BatchNorm statistics summed over the world, not the data "
               "group") + f"; in float64) fails the float64 gradient "
            f"check: {msg}")
    log("tensor-parallel", f"dryrun_multichip(4) on the card (a 2 x 2 mesh "
                           f"of gloo ranks sharing it): every track finite "
                           f"and equal on every rank in {dryrun_s:.1f} s; "
                           f"the meshes' ranks took {spawn_s:.1f} s from "
                           f"spawn to results; {nccl}")


def _timed(phase, *args):
    """phase(*args), then its seconds on a line of their own."""
    t0 = time.monotonic()
    out = phase(*args)
    log("seconds", f"{phase.__name__}: {time.monotonic() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import samplenet_tpu_torch

    pkg = os.path.dirname(os.path.abspath(samplenet_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"run chip_smoke.py from a checkout: "
                           f"samplenet_tpu_torch came from {pkg}")
    t0 = time.monotonic()
    card = _timed(phase_env, torch)
    costs = _timed(phase_build)
    errs = _timed(phase_compare, torch)
    _timed(phase_compare_nan, torch)
    _timed(phase_compare_nn, torch)
    model = make_model(torch, DEVICE)
    clouds = np.random.default_rng(SEED + 4).standard_normal(
        (B, N, 3)).astype(np.float32)
    counts = _timed(phase_end_to_end, torch, model, clouds)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "sampler.pth")
        torch.save({f"sampler.{k}": v.cpu() for k, v in
                    model.state_dict().items()}, weights)
        _timed(phase_serve, torch, model, weights)
        _timed(phase_artifact, torch, model, weights, tmp)
    train_errs = _timed(phase_compare_train, torch)
    data, labels, classifier = make_train_setup(torch)
    train_counts = _timed(phase_train_step, torch, data, labels, classifier)
    _timed(phase_train_cli, torch, classifier)
    errs.update(_timed(phase_compare_recon, torch))
    recon_data, recon_x = make_recon_data(torch)
    recon_counts = _timed(phase_recon_train, torch, recon_data, recon_x)
    _timed(phase_recon_cli, torch)
    _timed(phase_ae_analysis, torch, recon_data)
    prog_errs = _timed(phase_compare_progressive, torch)
    px = torch.from_numpy(data[:PROG_B]).to(DEVICE)
    py = torch.from_numpy(labels[:PROG_B]).to(DEVICE)
    _timed(phase_progressive_step, torch, px, py, classifier)
    prog_counts = _timed(phase_progressive_path, torch, px, py,
                         data[:2 * PROG_B], labels[:2 * PROG_B], classifier)
    _timed(phase_progressive_ae, torch, recon_data, recon_x)
    _timed(phase_progressive_cli, torch, classifier)
    with tempfile.TemporaryDirectory() as tmp:
        _timed(phase_classifier, torch, data, labels, tmp)
        _timed(phase_evaluate, torch, model, data, labels, tmp)
    _timed(phase_compare_registration, torch)
    reg_per_step = _timed(phase_registration_step, torch)
    _timed(phase_registration_cli, torch)
    errs.update(_timed(phase_compare_bf16, torch))
    bf16_counts = _timed(phase_bf16, torch, model, clouds, data, labels,
                         classifier)
    _timed(phase_bf16_cli, torch)
    _timed(phase_data_parallel, torch, classifier)
    _timed(phase_tensor_parallel, torch)
    times = _timed(phase_times, torch, model, clouds, card)
    train_times, soft_gathered = _timed(phase_times_train, torch, data,
                                        labels, classifier, card)
    times.update(train_times)
    times.update(_timed(phase_times_nn, torch, card, costs))
    times.update(_timed(phase_times_recon, torch, recon_x, card))
    times.update(_timed(phase_times_progressive, torch, px, py, recon_x,
                        classifier, card))
    _timed(phase_times_registration, torch, reg_per_step, card)
    times.update(_timed(phase_times_bf16, torch, model, clouds, data,
                        labels, classifier, card))
    counts = {**counts, **{k: train_counts[k] for k in TRAIN_KERNELS},
              **{k: recon_counts[k] for k in RECON_KERNELS},
              **{k: prog_counts[k] for k in PROG_KERNELS}, **bf16_counts}
    errs.update(train_errs)
    errs.update(prog_errs)
    bounds = kernel_bounds(soft_gathered)
    # no single PyTorch call computes any of these functions (a distance
    # matrix, a top-k or a matmul is one step of each), so library_ms is null
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1].split(" ")[0],
         "library_ms": None}
        for name, (src, rep) in {**KERNELS, **TRAIN_KERNELS,
                                 **RECON_KERNELS, **PROG_KERNELS,
                                 **BF16_KERNELS}.items()]}
    log("done", f"all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(_tp_nccl_rank() if sys.argv[1:] == ["--tp-nccl"] else main())
