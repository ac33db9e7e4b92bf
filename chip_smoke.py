"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

On a host with N cards, ``python3 chip_smoke.py --devices N`` runs only the
data-parallel phase (6b), its ranks over NCCL, one a card.

Phases, in order; any failure ends the run with a non-zero exit code:
  1. require a CUDA device (no CPU fallback), print the card's name and
     power limit, turn TF32 off for the fp32 references;
  2. build the kernels with nvcc for sm_90a, one compiler per source at
     once (K1 and K2 in dir_tpu_torch/csrc/fused_bottleneck.cu, K3 in
     fused_bottleneck_int8.cu, K4 in fused_stem_bottleneck.cu, K5 in
     bone_splat.cu), and print their register, spill and shared-memory
     reports;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes (K1 in both residual forms at the layer1 shape, K2 at the
     layer2 shape, K3 at both, K4 at the stem's shape, K5 at both refine
     stages' sizes), and time the kernel (K1-K4 on operands prepared once,
     with the whole wrapper beside), the plain version and, for the
     bottlenecks, the unfused library block (cuDNN for the bf16 kernels, the
     port's own unfused int8 block for K3: yardsticks the fused routes never
     call); then the fused eval sites' pass (``bias_add_relu_kernel``,
     Triton, ops/conv_epilogue.py) against its plain version at A's stem,
     layer1_0 conv3 (with the residual) and layer3 conv1 shapes at batch
     1,024, to the bit, timed beside the plain version and its byte bound;
  3b. the reference: the port on the card against dir_tpu's own outputs
     on the same full-size weights and inputs, recorded on the CPU
     (tests/data/torch_port_reference.npz, written by
     tests/torch_port_reference.py, read with numpy by
     dir_tpu_torch/reference.py): the seeded weights drawn here and
     checked against the record's digest, its conditioned BatchNorm
     statistics and MANO head biases loaded; 4 images through fp32 A with
     TF32 off (no kernel: the guards send fp32 to the unfused blocks)
     against dir_tpu's fp32 A, then once with TF32 on for cuDNN, which the
     bounds must catch (a negative control); bf16 A (K1 x 2) and B (K1 x 2,
     K2 x 3, K5 x 4) against the fp32 records and int8 C (K3 x 5) on
     dir_tpu's recorded scales against its C, in mm of the final stage
     (C's seg labels and dense map too); one fp32 train step of T (K5 x 4
     in the forward) against dir_tpu's value_and_grad: loss terms, every
     gradient's norm, two whole gradients; then a bf16 step and a step on
     one row of the batch, which T's bounds must catch;
  4. serve requests of batch 1, 8 and 64 through the full-width bf16
     flagship (ResNet-50, 256x256, seeded random weights) in configuration
     A (K1 at layer1, factored splat conv) and, on the same weights, in
     configuration B (K1 at layer1, K2 at layer2, the materialized bone
     splat through K5) and in configuration C (int8 static serving,
     calibrated on a seeded batch: K3 at layer1 and layer2, no other
     kernel, each block's K3 operands made once over the three requests);
     check every output and each kernel's launches per request (and the
     fused eval sites' pass's: 60 in A, 51 in B, 0 in C),
     hold the kernels against their plain versions on what the path fed
     them at batch 64, compare each final stage with the port's fp32 forward
     on the card (also through the port's batch_metrics), and time the
     requests of all three configurations;
  4b. export B and C (calibrated above) as serving artifacts with a
     symbolic batch (``serve.export_program``: the kernels are the
     ``torch.ops.dir_tpu.*`` ops the graphs name: B fused_bottleneck x 5
     and bone_splat x 4, C fused_bottleneck_int8 x 5), write them under
     build/, load B in a fresh process that must not import the models,
     serve B through ``apps/serve_http.py`` (micro-batcher of 8, buckets 1
     and 8) and C (single flight) on a local port: batch 1, batch 8 and 8
     concurrent batch-1 requests, every response held against the live
     model, the kernels' launches per dispatch from their counters, the
     HTTP latency per request shape (min, median, p90, max over at least
     50 requests) beside the same calls in process, and the CUDA operations per
     request of artifact and live model; then the infer app on one seeded
     image (full depth, fp32);
  5. train the full-width flagship on the card: configuration T (bf16
     trunk, B's decoder flags, so K5 runs on each step's forward; batch 64,
     bench.py:bench_train's seeded batch), a few AdamW steps on the
     repeated batch with ms per step (host clock and CUDA events), peak
     memory and K5's launches per step
     (set to 0 just before, read just after), a finite and falling loss and
     moved parameters; two steps of the default decoder (the factored splat
     conv, no kernel); and K5's training route against the plain splat at
     fp32 (loss and every parameter's gradient), the plain route run twice
     under deterministic algorithms, which must repeat to the bit;
  5b. F2: T's steps twice from one state_dict through the port's train
     step (deterministic algorithms): losses, BN statistics and parameters
     bit-equal; the same steps with the deterministic mode patched out
     beside them (ms per step); the decoder's 2x upsample and joint
     sampling (the port's forms, the library calls they replace, the
     transposed-conv form) timed forward and backward at the eval batch's
     shapes;
  5c. ``python -m dir_tpu_torch.apps.convergence`` at full width (320 AdamW
     steps on one synthetic batch of 64): its curve, finite, the last loss
     at most 0.75 of the first;
  6. drive the Trainer on the card: configuration T's model (the flagship
     with B's flags, bf16, conditioned random weights) through
     ``Trainer.make_data/make_model/train`` on a synthetic split (128 train,
     64 test samples, written by the port's writer), device pipeline, batch
     64: 1 epoch with its in-loop eval, then a second Trainer resumed from
     ``latest`` (epoch, step, best and the augmentation generator's state
     checked) for a second epoch, which must end bit-equal (parameters and
     BN statistics) to a Trainer that ran the two epochs in one go (as
     tests/test_train_e2e.py:test_trainer_resume_trajectory holds the JAX
     package's: the cosine lr of epoch 0 is the same whatever the total),
     then one epoch on the host path
     (uint8 wire format). The counts are set to 0 just before and read just
     after; every step must launch K5 4 times and nothing else, every eval
     batch K1 2, K2 3 and K5 4 times. K1, K2 and K5 are held against their
     plain versions on what the last in-loop eval fed them. Prints ms per
     step, the loader's wait and share, ms per eval batch, the losses, the
     summaries and peak memory; then the train CLI (``apps/train.py``) for
     one epoch of 2 steps of T's flags on the same split;
  6b. data parallelism (``dir_tpu_torch/parallel/``): (a) configuration T
     at global batch 64 through ``make_train_step(mesh=...)`` on a mesh of
     one NCCL rank, 2 warm-up and 3 timed steps, against the same steps
     without a mesh, within the spread bound and bit-equal; (b) two ranks
     sharing the one card over gloo (CUDA tensors; NCCL refuses two ranks
     on one card), 32 a rank, 3 steps
     against the single process on the same global batches, within a bound
     from the single process's own spread with the batch's halves swapped,
     both ranks' states bit-identical; then ``apps/train.py``'s main in two
     gloo ranks, started as torchrun starts them, for one epoch of the
     Trainer's split with the device pipeline, its in-loop summary against
     one rank's on the same weights at the ranks' batch of 32. Every step
     must launch K5 4 times a rank, every eval batch K1 2, K2 3 and K5 4
     times a rank; prints each backend, ms per step (two processes
     time-slicing one card in (b): no multi-card step) and the errors; then
     ``apps/eval.py --devices N --quant_static --quant_fused`` (C's int8
     flags) in as many ranks over the same split, K3's launches counted in
     each rank and its SUMMARY against ``--devices 1``;
  7. serve an fp32 trunk under the fused flags (the bf16 kernels' and C's)
     at cut depth: the kernels take bf16 only, so the guards route the
     blocks unfused;
  8. the bench: ``python -m dir_tpu_torch.bench`` (the counterpart of
     bench.py) at cut repetitions (BENCH_ENV) in its own process, its last line
     holding bench.py's keys, all positive, and the card's name; K1's
     launches counted here over one unrolled eval call of the bench's
     flagship at batch 256 (8 forwards, K1 twice each, nothing else); then
     each measurement tool (``dir_tpu_torch/tools``: serving latency, train
     step, loader-fed training, input pipelines, int8 accuracy, concurrent
     HTTP serving, component times; ``profile_serve --batches 256``) once
     at cut repetitions, all at once, each in its own process, their lines
     printed; the component tool's lines held (the JAX tool's nine entries
     by name and in order, each after its traced ``component`` line, K5
     launched once on each ``_pallas`` entry and on no other); the tool's
     splats at its batch-64 draws, K5 against its plain version in this
     process; any failure fails the run;
  9. print the ``parallel`` line, the ``bench`` line, the ``phases`` line
     (seconds of each phase), the ``reference`` line (its errors, bounds,
     launches and seconds), the ``kernels`` line (launches of the main
     path: the reference phase's runs, A, B and C served, the B and C artifacts
     over HTTP, T, F2's runs, the Trainer and the data-parallel runs of 6b,
     over their ranks, the bench's eval call and, for K5, the component
     tool's traced calls; for ``bias_add_relu_kernel`` A's, B's and C's
     requests), then the one-line result.
"""

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re

# cuBLAS is deterministic only with a fixed workspace; set before torch loads
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_INT8_OP_PER_S = 1979e12
PEAK_FP32_FLOP_PER_S = 67e12

# K1 and K2 against their plain version at the path's shapes: bf16 outputs
# may differ where an fp32 sum in another order rounds an intermediate the
# other way. Bound: KERNEL_TOL_ULPS bf16 ulps (2^-8 relative) of the output's
# max |value|; measured one ulp (0.03125 at |out| up to 6.06, seed 0).
KERNEL_TOL_ULPS = 4
# K5 against its plain version: one ulp of the feature dtype at the output's
# max |value|, outside the (pixel, bone) pairs within 1e-4 px
# (ops/bone_splat.py:THRESHOLD_MARGIN_PX) of the mask's threshold in the plain
# version's fp32 geometry (there the step can fall either way under another
# rounding); at most SPLAT_MAX_LEFT_OUT of the pairs may be left out.
SPLAT_MAX_LEFT_OUT = 1e-3
# bf16 trunk with the kernels against the fp32 unfused forward on the card:
# max abs error over the final stage's joints and meshes of both hands, in
# mm. The bf16 unfused forward shows the same error (measured 7.5 mm at batch
# 64 against 6.3 mm with K1, seed 0), so the bound is bf16's, not a kernel's.
SERVE_TOL_MM = 15.0
# K3 against its plain version: the s32 sums are exact and every rounding is
# the same operation in both, so the two are bit-equal (measured 0 mismatched
# elements at both shapes and on the served activations); the bound is one
# bf16 ulp (2^-8 relative) of the output's max |value|.
INT8_TOL_ULPS = 1
# Configuration C (int8 static, bf16 trunk) against the fp32 forward, same
# measure as SERVE_TOL_MM. Int8 has its own error on top of bf16's: measured
# 6.0 / 7.9 / 8.5 mm at batch 1 / 8 / 64 (A: 4.2 / 5.1 / 6.3), seed 0. The
# bound is about twice the worst, as SERVE_TOL_MM is of bf16's: it catches a
# path that breaks, not quantization noise.
SERVE_TOL_MM_INT8 = 20.0
# images of the seeded calibration batch of configuration C
CALIBRATION_BATCH = 16
BATCHES = (1, 8, 64)
LATENCY_REPS = 11
K1_SHAPE = (256, 64, 64, 256)      # layer1_1 / layer1_2 at eval batch 256
K1_MID = 64
K2_SHAPE = (256, 32, 32, 512)      # layer2_1..3 at eval batch 256
K2_MID = 128
K2_BANDS = 4
# K3 at eval batch 256: (shape, mid, bands) of layer1_1/1_2 and layer2_1..3
K3_SHAPES = ((K1_SHAPE, K1_MID, 1), (K2_SHAPE, K2_MID, 4))
K4_SHAPE = (256, 128, 128, 64)     # the raw stem-conv output at eval batch 256
K4_MID, K4_OUT = 64, 256           # layer1_0
# K5 at eval batch 256: (batch, S, C, distance) of the two refine stages
K5_SHAPES = ((256, 32, 64, 2.0), (256, 16, 64, 1.0))
KERNELS = ("K1", "K2", "K3", "K4", "K5")
CONFIGS = "ABC"
# launches per request of (K1, K2, K3, K4, K5) in the three configurations,
# and per optimizer step in configuration T (training: the fused
# bottlenecks are inference-only); no model calls K4, in the JAX package or
# here
EXPECTED = {"A": (2, 0, 0, 0, 0), "B": (2, 3, 0, 0, 4), "C": (0, 0, 5, 0, 0),
            "T": (0, 0, 0, 0, 4)}
# ... per in-loop eval batch of the Trainer (its steps launch T's)
EXPECTED_TRAINER_EVAL = (2, 3, 0, 0, 4)
# The eval forward's fused sites (ops/conv_epilogue.py): the pass after the
# folded conv, bias_add_relu_kernel, at A's shapes at batch 1,024, bf16
# channels-last: (site, conv output (B, C, H, W), with a residual z) of the
# stem, layer1_0's conv3 (z its projection) and a layer3 block's conv1
EPILOGUE_SHAPES = (("stem", (1024, 64, 128, 128), False),
                   ("l1_0.c3", (1024, 256, 64, 64), True),
                   ("l3_x.c1", (1024, 256, 16, 16), False))
# fused calls a request (conv_bias_relu.fused_runs; one launch of the pass
# each) in A, B and C: the stem, 3 in each block that neither K1 nor K2
# takes (14 in A, 11 in B), 2 in each of the decoder's 6 Residuals, 1 in
# each of its 5 ConvHeads; C's int8 paths take none
EXPECTED_EPILOGUE = {"A": 60, "B": 51, "C": 0}
# Configuration T: bench.py:bench_train's batch; warm-up and timed steps on
# the repeated batch; steps of the default decoder
TRAIN_BATCH = 64
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
DEFAULT_DECODER_STEPS = 2
# F2: configuration T's timed steps, run twice from one state_dict; the
# decoder's 2x upsample inputs (c4, stage 1's enhanced map) and sampled maps
# (the two refine stages) at eval batch 256, bf16, with both hands' joints
F2_STEPS = 5
F2_UPSAMPLE_SHAPES = ((256, 8, 8, 2048), (256, 16, 16, 256))
F2_SAMPLE_SHAPES = ((256, 16, 16, 256), (256, 32, 32, 256))
F2_POINTS = 42
# The loss on the repeated batch after T's steps over the first step's: at
# most this (measured 0.818 on the card, seed 0).
TRAIN_LOSS_RATIO = 0.92
# K5's training route against the plain splat: fp32, TF32 off, this batch,
# under deterministic algorithms. Both backwards are the plain version's;
# the forwards differ only at the (pixel, bone) pairs near the mask's
# threshold and by an fp32 ulp. Measured before the train path was
# deterministic (seed 0): the loss equal, the worst gradient 3.4e-5 of the
# larger of its max |value| and GRAD_FLOOR of the largest gradient of all,
# where the plain route against itself gave 3.3e-5 (cuDNN's and the
# scatters' atomics); 2 of 819,200 (pixel, bone) pairs within 1e-4 px of the
# threshold. Under deterministic algorithms the plain route repeats to the
# bit, and must. Bounds: the loss to K5_TRAIN_LOSS_RTOL relative, every
# gradient to K5_TRAIN_GRAD_RTOL in that measure, about ten times that
# spread.
K5_TRAIN_BATCH = 16
K5_TRAIN_LOSS_RTOL = 1e-6
K5_TRAIN_GRAD_RTOL = 3e-4
GRAD_FLOOR = 1e-4
# The Trainer on the card: synthetic split sizes (2 steps an epoch, 1 eval
# batch), epochs before the resume and after it (the resumed run is held
# against an uninterrupted one of as many epochs; the lr schedule is cosine
# over the run's epochs, and only epoch 0's lr is the same for every total)
TRAINER_TRAIN, TRAINER_TEST = 128, 64
TRAINER_EPOCHS, TRAINER_RESUMED_EPOCHS = 1, 2
# The serving artifacts: the kernel ops each exported graph names
ARTIFACT_OPS = {
    "B": {"fused_bottleneck": 5, "fused_bottleneck_int8": 0,
          "fused_stem_bottleneck": 0, "bone_splat": 4},
    "C": {"fused_bottleneck": 0, "fused_bottleneck_int8": 5,
          "fused_stem_bottleneck": 0, "bone_splat": 0}}
# HTTP responses against the live model on the same images at the batch
# size they were dispatched at: the final stage in mm and the seg and dense
# maps. The artifact runs the live model's ops on the same tensors: measured
# 0 for both artifacts over three calls, at batch 1, 8 and in B's
# micro-batches, whatever a request's position or neighbours in its batch
# (NVIDIA H100 80GB HBM3, 700 W). The same image at batch 1 and in a batch
# of 8 differs by up to 9.0 mm and 3.1 on the maps (bf16 under other cuDNN
# algorithms), two images by at least 7.0 mm and 24.7: the bounds catch a
# wrong reference size or a row given to another request.
HTTP_TOL_MM = 1e-3
HTTP_TOL_MAP = 1e-4
# Requests timed for each request shape (a burst counts its 8), and calls
# of the artifact and of the live model in process, beside them
HTTP_REQUESTS = 50
IN_PROCESS_REPS = 20
HTTP_WINDOW_MS = 3.0
# The fp32 trunk under the fused flags against the same model without them:
# the same fp32 computation, up to cuDNN's choice of algorithm.
F1_RTOL = 1e-5
# The data-parallel phase: configuration T at global batch 64, warm-up and
# timed steps of (a), the steps of (b), the seed of its first batch, and the
# seconds its rank processes may take. On one card (b) runs two gloo ranks
# sharing it; ``--devices N`` runs N NCCL ranks, one a card.
DP_WARMUP, DP_STEPS = 2, 3
DP_SEED = 10
DP_TIMEOUT = 600
# Each run is held against the single process's steps without a mesh in
# three measures: the worst loss term over the steps (relative), the BN
# running statistics (of each tensor's max) and the parameters (in lr).
# Before the train step ran under deterministic algorithms, the same steps
# run again moved a loss term by 3.7 % and a statistic by 19 % of its
# tensor's max after 5 steps (NVIDIA H100 80GB HBM3, 700 W), as cuDNN's and
# the scatters' atomics summed in another order and Adam's normalized update
# magnified the difference; (a) is now also held bit-equal. The bound of
# each measure is DP_SPREAD_FACTOR
# times the single process's own spread over the same steps, and at least
# the floor: (a), one NCCL rank, where every collective is the identity,
# against the spread of the steps repeated; (b), two ranks (the same
# computation in another order: global BatchNorm moments summed over ranks,
# cuDNN at batch 32), against the larger of that spread and the spread under
# a reordering of the same work, the steps with the batch's halves swapped.
DP_SPREAD_FACTOR = 4.0
DP_FLOORS = {"loss": 1e-6, "stats": 1e-5, "param_lr": 1e-2}
# The two-rank train app's in-loop summary against one rank's on the same
# weights at batch 32 (each rank's block): the same forwards, the sums
# added in another order; relative. The same bound holds the two-rank eval
# app with K3 (two ranks of 32) against one rank (64) on the same weights,
# calibration batch and samples (measured 1.1e-7 in two calls, NVIDIA H100
# 80GB HBM3, 700 W).
DP_SUMMARY_RTOL = 1e-4
# The convergence app (apps/convergence.py at its defaults: 320 steps of
# 64, constant lr): the last step's loss at most this share of the first's,
# and the seconds it may take.
CONVERGENCE_RATIO = 0.75
CONVERGENCE_TIMEOUT = 400
# The bench phase: ``python -m dir_tpu_torch.bench`` at cut repetitions and
# the seconds it may take; the keys its last line must carry (bench.py's and
# the card's); the unrolled eval call whose launches are counted in this
# process; then every measurement tool once at cut repetitions, all at once,
# each in its own process, and the seconds they may take together.
BENCH_TIMEOUT = 480
# The bench at cut repetitions (its own knobs: 2 forwards or steps a call
# against its 8, its 3 warm-up and 10 timed calls of each half kept): this
# phase checks its line, the bench measures alone.
BENCH_ENV = {"EVAL_UNROLL": "2", "UNROLL": "2"}
BENCH_KEYS = ("value", "vs_baseline", "train_step_ms_b64", "train_img_per_sec",
              "serving_int8_static_img_per_sec")
BENCH_UNROLL = 8
TOOLS_TIMEOUT = 360
TOOLS = (
    ("bench_serve_latency", ["-m", "dir_tpu_torch.tools.bench_serve_latency"],
     {"ITERS": "3"}),
    ("bench_train", ["-m", "dir_tpu_torch.tools.bench_train"],
     {"ITERS": "2"}),
    ("bench_train_pipeline", ["-m", "dir_tpu_torch.tools.bench_train_pipeline",
                              "--device", "--steps", "2", "--samples", "32",
                              "--batch", "16"], {}),
    ("bench_input_pipeline", ["-m", "dir_tpu_torch.tools.bench_input_pipeline",
                              "--device", "--n", "16", "--batch", "8"], {}),
    ("quant_accuracy", ["-m", "dir_tpu_torch.tools.quant_accuracy",
                        "--samples", "4", "--bs", "4", "--fused_bottleneck"],
     {}),
    ("bench_serve_concurrent",
     ["-m", "dir_tpu_torch.tools.bench_serve_concurrent"],
     {"CLIENTS": "4", "REQS": "3", "MB": "4", "BUCKETS": "1,4"}),
    ("profile_serve", ["-m", "dir_tpu_torch.profile_serve", "--batches",
                       "256"], {}),
    ("bench_components", ["-m", "dir_tpu_torch.tools.bench_components"], {}),
)
# The reference phase: the port on the card against dir_tpu's own outputs on
# the same full-size weights and inputs (tests/data/torch_port_reference.npz,
# written on the CPU by tests/torch_port_reference.py; dir_tpu_torch/
# reference.py reads it). fp32 A with TF32 off: max abs error by kind of
# output (reference.kind), leaving out for each image what a near-threshold
# splat pair can move (reference.first_moved). Measured on the card (NVIDIA
# H100 80GB HBM3, 700 W): xyz 9.6e-7 m, uv 6.5e-6, the rest 6.2e-6, seg/dense
# 2.1e-3 (logits up to 31); each bound about ten times. The negative
# control, the same run with TF32 on for cuDNN against the same record,
# read xyz 1.5e-3 m, uv 1.1e-2, the rest 9.2e-3 and seg/dense 3.0: every
# bound catches it, xyz at 150 times.
REFERENCE_RECORD = os.path.join(REPO, "tests", "data",
                                "torch_port_reference.npz")
REFERENCE_FP32_TOL = {"xyz": 1e-5, "uv": 1e-4, "other": 1e-4, "head": 3e-2}
# bf16 A and B (the kernels on the path) against the fp32 record, int8 C (K3)
# against C's record, each as SERVE_TOL_MM measures: max abs error over the
# final stage's joints and meshes, both hands, in mm. Measured 4.43 (A), 4.68
# (B) and 5.45 mm (C; the CPU's plain route 5.12); bounds about twice.
REFERENCE_BF16_MM = 10.0
REFERENCE_INT8_MM = 11.0
# C's seg/dense heads, which amplify that rounding, by reference.head_errors:
# seg labels flipped where the record's margin is sure, dense relative RMS.
# tests/test_torch_port_reference.py's bounds: measured on the card 0.052
# and 0.476 (NVIDIA H100 80GB HBM3, 700 W), on the CPU 0.051 and 0.478; a
# zero, a shuffled and an unquantized output each break both.
REFERENCE_INT8_HEADS = {"seg_label_share": 0.1, "dense_rel_rms": 0.7}
# One fp32 step of T's train path (K5 in the forward, the plain backward)
# against dir_tpu's value_and_grad: the worst loss term (relative), the worst
# parameter's gradient norm (relative, reference.GRAD_NORM_FLOOR) and the
# whole gradients of reference.WHOLE_GRADS (max abs error over the tensor's
# max). Measured 4.4e-5, 1.7e-2 and 4.3e-2. dir_tpu's own fp32 step stands
# as far from its fp64 one (4.6e-5, 1.6e-2, 3.3e-2: the backward through the
# full depth's train-mode BatchNorms at batch 2 magnifies fp32 rounding),
# while the two packages at fp64 agree to 2.9e-14, 1.6e-9 and 3.2e-13 on the
# CPU (tests/test_torch_port_reference.py). Bounds about ten times. Two
# known-wrong steps, its negative controls, break all three: the bf16 trunk
# (the bench's training precision) 1.0e-2, 0.82 and 1.30, the batch cut to
# one row 0.30, 0.73 and 1.52.
REFERENCE_T_TOL = {"loss_rel": 5e-4, "grad_norm_rel": 0.2,
                   "whole_grad_rel": 0.4}
# launches per forward of (K1, K2, K3, K4, K5) in the reference phase's runs
EXPECTED_REFERENCE = {"fp32 A": (0, 0, 0, 0, 0), "bf16 A": EXPECTED["A"],
                      "bf16 B": EXPECTED["B"], "int8 C": EXPECTED["C"],
                      "T": EXPECTED["T"]}
# The component tool's two lines per entry: the traced call's, then the JAX
# tool's (tools/bench_components.py:30-31).
COMPONENT_LINE = re.compile(r"component (\S+): device_ms=([\d.]+) "
                            r"launches=(\d+) busy=([\d.]+)% k5=(\d+)$")
COMPONENT_JAX_LINE = re.compile(r"(\S+): ([\d.]+) ms/iter \((\d+) img/s\)$")


def say(msg: str) -> None:
    print(f"[chip_smoke +{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


T0 = time.monotonic()


@contextlib.contextmanager
def traced_ops():
    """The live model on the ops an exported artifact holds: the fused eval
    route of ``ops/conv_epilogue.py`` off, as it is while exporting."""
    from dir_tpu_torch.ops import conv_epilogue
    engages = conv_epilogue.engages
    conv_epilogue.engages = lambda module, x: False
    try:
        yield
    finally:
        conv_epilogue.engages = engages


def time_cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(fb, x, ws, what: str, bands: int = 0):
    """The fused bottleneck (K1, or K2 with ``bands``) against its plain
    version on ``x``; returns the max abs error and the plain result, raises
    past KERNEL_TOL_ULPS bf16 ulps of the output's max |value|."""
    name = "K2" if bands else "K1"
    out = fb.fused_bottleneck_infer(x, *ws, bands=bands)
    ref = fb.fused_bottleneck_infer_plain(x, *ws)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = float(ref.float().abs().max())
    tol = KERNEL_TOL_ULPS * 2.0 ** -8 * scale
    say(f"{name} {what}: max abs err {err:.6g} (max |out| {scale:.6g}, "
        f"tolerance {tol:.6g}), mismatched elements "
        f"{float((diff > 0).float().mean()):.3g}")
    if not (err <= tol and torch.isfinite(out).all()):
        raise RuntimeError(f"{name} ({what}) disagrees with its plain version")
    return err, ref


def folded_weights(g, c: int, mid: int, o: int, down: bool) -> list:
    """Seeded folded weights of one bottleneck in the kernels' argument order
    ``[w1, b1, w2, b2, w3, b3, wd, bd]``, fp32 on the card, with a fan-in
    scale; ``wd`` and ``bd`` None without a projection."""
    dev = g.device

    def weight(*shape):
        fan_in = 1
        for s in shape[:-1]:
            fan_in *= s
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) / fan_in ** 0.5

    def bias(n):
        return torch.rand(n, generator=g, device=dev) - 0.5

    ws = [weight(c, mid), bias(mid), weight(3, 3, mid, mid), bias(mid),
          weight(mid, o), bias(o)]
    return ws + ([weight(c, o), bias(o)] if down else [None, None])


def cudnn_block(ws):
    """The unfused bf16 block on the folded weights ``ws`` through cuDNN, as
    a function of the channels_last NCHW input: the bf16 kernels' yardstick,
    which the port never calls."""
    bf = torch.bfloat16
    cl = torch.channels_last
    down = ws[6] is not None
    w1c = ws[0].t()[:, :, None, None].to(bf).contiguous(memory_format=cl)
    w2c = ws[2].permute(3, 2, 0, 1).to(bf).contiguous(memory_format=cl)
    w3c = ws[4].t()[:, :, None, None].to(bf).contiguous(memory_format=cl)
    b1c, b2c, b3c = (t.to(bf) for t in (ws[1], ws[3], ws[5]))
    if down:
        wdc = ws[6].t()[:, :, None, None].to(bf).contiguous(memory_format=cl)
        bdc = ws[7].to(bf)

    def block(xc):
        y = F.relu(F.conv2d(xc, w1c, b1c))
        y = F.relu(F.conv2d(y, w2c, b2c, padding=1))
        y = F.conv2d(y, w3c, b3c)
        res = F.conv2d(xc, wdc, bdc) if down else xc
        return F.relu(y + res)

    return block


def bound(nbytes: int, ops: int, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": ops}


def bottleneck_phase(fb, shape, mid: int, bands: int, forms):
    """K1 (``bands`` 0) or K2 against the plain version at ``shape``, in the
    residual ``forms`` given, with timings and the bound."""
    name = "K2" if bands else "K1"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, w, c = shape
    o = c
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    results = {}
    for form in forms:
        down = form == "projection"
        ws = folded_weights(g, c, mid, o, down)
        err, ref = compare(fb, x, ws, form, bands)

        # the unfused cuDNN block on the same folded weights (yardstick)
        xc = x.permute(0, 3, 1, 2)
        block = cudnn_block(ws)

        def library():
            return block(xc)

        lib_err = float((library().permute(0, 2, 3, 1).float()
                         - ref.float()).abs().max())
        del ref
        # the kernel on operands prepared once, and the whole wrapper, which
        # also lays the weights out (one gather) on every call
        operands = fb.kernel_operands(*ws, bands=bands)
        kernel_ms = time_cuda_ms(lambda: fb.launch(x, operands, bands), 20)
        wrapper_ms = time_cuda_ms(
            lambda: fb.fused_bottleneck_infer(x, *ws, bands=bands), 20)
        plain_ms = time_cuda_ms(
            lambda: fb.fused_bottleneck_infer_plain(x, *ws), 5)
        library_ms = time_cuda_ms(library, 20)

        weight_bytes = sum(t.numel() * (2 if t.dim() > 1 else 4)
                           for t in ws if t is not None)
        nbytes = x.numel() * 2 + b * h * w * o * 2 + weight_bytes
        flops = 2 * b * h * w * (c * mid + 9 * mid * mid + mid * o
                                 + (c * o if down else 0))
        results[form] = {
            "max_abs_err": err, "ms": kernel_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err,
            **bound(nbytes, flops, PEAK_BF16_FLOP_PER_S),
        }
        say(f"{name} {form}: kernel {kernel_ms:.4f} ms on prepared operands "
            f"(wrapper {wrapper_ms:.4f} ms), plain {plain_ms:.4f} "
            f"ms, cuDNN block {library_ms:.4f} ms (max abs err {lib_err:.4g}), "
            f"bound {results[form]['bound_ms']:.4f} ms "
            f"({results[form]['bound_by']})")
    return results


def compare_int8(q8, x, ws, scales, what: str, bands: int = 1):
    """The fused int8 bottleneck (K3) against its plain version on ``x`` with
    the static ``scales``; returns the max abs error, raises past
    INT8_TOL_ULPS bf16 ulps of the output's max |value|."""
    out = q8.fused_bottleneck_int8_infer(x, *ws[:6], *scales, ws[6], ws[7],
                                         bands=bands)
    ref = q8.fused_bottleneck_int8_infer_plain(x, *ws[:6], *scales, ws[6],
                                               ws[7])
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = float(ref.float().abs().max())
    tol = INT8_TOL_ULPS * 2.0 ** -8 * scale
    say(f"K3 {what}: max abs err {err:.6g} (max |out| {scale:.6g}, "
        f"tolerance {tol:.6g}), mismatched elements "
        f"{float((diff > 0).float().mean()):.3g}")
    if not (err <= tol and torch.isfinite(out).all()):
        raise RuntimeError(f"K3 ({what}) disagrees with its plain version")
    return err


def unfused_int8_block(quant, x, ws, scales):
    """The port's unfused int8 block (what ``Bottleneck._quant_infer`` runs
    where K3's guard does not take the block) on the NHWC ``x``: K3's
    yardstick."""
    w1, b1, w2, b2, w3, b3, wd, bd = ws
    dt = x.dtype
    y = F.relu(quant.quant_conv(x, w1[None, None], bias=b1, out_dtype=dt,
                                act_scale=scales[0]))
    y = F.relu(quant.quant_conv(y, w2, (1, 1), ((1, 1), (1, 1)), b2, dt,
                                act_scale=scales[1]))
    y = quant.quant_conv(y, w3[None, None], bias=b3, out_dtype=dt,
                         act_scale=scales[2])
    res = x if wd is None else quant.quant_conv(
        x, wd[None, None], bias=bd, out_dtype=dt, act_scale=scales[0])
    return F.relu(y + res)


def int8_phase(q8, quant):
    """K3 against its plain version at the layer1 and the layer2 shape
    (identity residual, as on the path), with timings and the bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for shape, mid, bands in K3_SHAPES:
        b, h, w, c = shape
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ws = folded_weights(g, c, mid, c, False)
        # static scales as a calibration would leave them: the |max| of each
        # conv's input over the first samples, through the float block
        xs = x[:8].float()
        y1 = F.relu(xs @ ws[0] + ws[1])
        y2 = F.relu(F.conv2d(y1.permute(0, 3, 1, 2), ws[2].permute(3, 2, 0, 1),
                             ws[3], padding=1))
        scales = [t.abs().max() / 127 for t in (x.float(), y1, y2)]
        what = f"{tuple(shape)}, mid {mid}, bands {bands}"
        err = compare_int8(q8, x, ws, scales, what, bands)
        lib = unfused_int8_block(quant, x, ws, scales)
        ref = q8.fused_bottleneck_int8_infer_plain(x, *ws[:6], *scales)
        lib_err = float((lib.float() - ref.float()).abs().max())
        del lib, ref
        # the kernel on operands prepared once (as configuration C's blocks
        # keep them), and the whole wrapper, which quantizes and lays out the
        # weights in some sixty small launches a call and so can be bound by
        # the host
        operands = q8.kernel_operands(*ws[:6], *scales)
        kernel_ms = time_cuda_ms(lambda: q8.launch(x, operands), 20)
        wrapper_ms = time_cuda_ms(
            lambda: q8.fused_bottleneck_int8_infer(x, *ws[:6], *scales,
                                                   bands=bands), 20)
        plain_ms = time_cuda_ms(
            lambda: q8.fused_bottleneck_int8_infer_plain(x, *ws[:6], *scales),
            3, warmup=1)
        library_ms = time_cuda_ms(
            lambda: unfused_int8_block(quant, x, ws, scales), 3, warmup=1)
        # the wrapper's inputs: x in bf16, the folded weights in fp32
        weight_bytes = sum(t.numel() * 4 for t in ws if t is not None) + 12
        nbytes = x.numel() * 2 + b * h * w * c * 2 + weight_bytes
        ops = 2 * b * h * w * (c * mid + 9 * mid * mid + mid * c)
        results.append({
            "shape": list(shape) + [mid], "max_abs_err": err, "ms": kernel_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_max_abs_err": lib_err,
            **bound(nbytes, ops, PEAK_INT8_OP_PER_S)})
        say(f"K3 {what}: kernel {kernel_ms:.4f} ms (wrapper with the "
            f"weights' quantization {wrapper_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, unfused int8 block {library_ms:.4f} ms (max "
            f"abs err "
            f"{lib_err:.4g}: it divides by the scale where K3 multiplies by "
            f"its reciprocal), bound {results[-1]['bound_ms']:.4f} ms "
            f"({results[-1]['bound_by']})")
    return results


def stem_phase(st):
    """K4 against its plain version at the stem's shape, with timings and
    the bound. The library time is ATen's affine, ReLU and max_pool2d plus
    the unfused cuDNN block."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, h2, w2, c = K4_SHAPE
    h, w = h2 // 2, w2 // 2
    x = torch.randn(K4_SHAPE, generator=g, device=dev).to(torch.bfloat16)
    g1 = torch.rand(c, generator=g, device=dev) + 0.5
    t1 = torch.rand(c, generator=g, device=dev) - 0.5
    ws = folded_weights(g, c, K4_MID, K4_OUT, True)
    out = st.fused_stem_bottleneck(x, g1, t1, *ws)
    ref = st.fused_stem_bottleneck_plain(x, g1, t1, *ws)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    scale = float(ref.float().abs().max())
    tol = KERNEL_TOL_ULPS * 2.0 ** -8 * scale
    say(f"K4 {K4_SHAPE} -> {tuple(out.shape)}: max abs err {err:.6g} (max "
        f"|out| {scale:.6g}, tolerance {tol:.6g}), mismatched elements "
        f"{float((diff > 0).float().mean()):.3g}")
    if not (err <= tol and torch.isfinite(out).all()
            and tuple(out.shape) == (b, h, w, K4_OUT)):
        raise RuntimeError("K4 disagrees with its plain version")

    xc = x.permute(0, 3, 1, 2)
    gc = g1.to(torch.bfloat16)[None, :, None, None]
    tc = t1.to(torch.bfloat16)[None, :, None, None]
    block = cudnn_block(ws)

    def library():
        return block(F.max_pool2d(F.relu(xc * gc + tc), 3, 2, 1))

    lib_err = float((library().permute(0, 2, 3, 1).float()
                     - ref.float()).abs().max())
    del ref, out
    # the kernel on operands prepared once, and the whole wrapper, which
    # also lays the weights out (one gather) on every call
    operands = st.kernel_operands(g1, t1, *ws)
    kernel_ms = time_cuda_ms(lambda: st.launch(x, operands), 20)
    wrapper_ms = time_cuda_ms(
        lambda: st.fused_stem_bottleneck(x, g1, t1, *ws), 20)
    plain_ms = time_cuda_ms(
        lambda: st.fused_stem_bottleneck_plain(x, g1, t1, *ws), 5)
    library_ms = time_cuda_ms(library, 20)
    weight_bytes = sum(t.numel() * (2 if t.dim() > 1 else 4) for t in ws)
    nbytes = x.numel() * 2 + b * h * w * K4_OUT * 2 + weight_bytes + 8 * c
    # the products, 2 operations per raw pixel and channel for the affine
    # and 9 comparisons per pooled one
    flops = (2 * b * h * w * (c * K4_MID + 9 * K4_MID * K4_MID
                              + K4_MID * K4_OUT + c * K4_OUT)
             + 2 * x.numel() + 9 * b * h * w * c)
    result = {"shape": list(K4_SHAPE) + [K4_MID, K4_OUT], "max_abs_err": err,
              "ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library_max_abs_err": lib_err,
              **bound(nbytes, flops, PEAK_BF16_FLOP_PER_S)}
    say(f"K4: kernel {kernel_ms:.4f} ms on prepared operands (wrapper "
        f"{wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, ATen "
        f"affine + ReLU + max_pool2d + cuDNN block {library_ms:.4f} ms (max "
        f"abs err {lib_err:.4g}), bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']})")
    return result


def compare_splat(bs, uv, feat, size: int, distance: float, what: str):
    """K5 against its plain version on ``(uv, feat)``, outside the pairs
    near the mask's threshold; returns the max abs error, raises past one
    ulp of the feature dtype at the output's max |value| or when too many
    pairs are left out."""
    out = bs.bone_splat(uv, feat, size, distance)
    ref = bs.bone_splat_plain(uv, feat, size, distance)
    near = bs.threshold_pairs(uv, size, distance)
    torch.cuda.synchronize()
    err, tol, left_out = bs.mismatch_outside_threshold(out, ref, near)
    say(f"K5 {what}: max abs err {err:.6g} (max |out| "
        f"{float(ref.float().abs().max()):.6g}, tolerance {tol:.6g}), "
        f"mismatched elements {float((out != ref).float().mean()):.3g} "
        f"(threshold pairs included), threshold pairs left out "
        f"{int(near.sum())} ({left_out:.3g} of all)")
    if not (err <= tol and left_out <= SPLAT_MAX_LEFT_OUT
            and torch.isfinite(out).all()):
        raise RuntimeError(f"K5 ({what}) disagrees with its plain version")
    return err


def splat_phase(bs):
    """K5 against its plain version at the two refine stages' shapes, bf16
    features, with timings and the bound. No single PyTorch call computes
    the splat, so there is no library time."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for b, size, c, distance in K5_SHAPES:
        uv = torch.rand((b, 21, 2), generator=g, device=dev) * 1.8 - 0.9
        feat = torch.randn((b, 21, c), generator=g, device=dev).to(
            torch.bfloat16)
        what = f"(B {b}, S {size}, C {c}, distance {distance})"
        err = compare_splat(bs, uv, feat, size, distance, what)
        kernel_ms = time_cuda_ms(
            lambda: bs.bone_splat(uv, feat, size, distance), 20)
        plain_ms = time_cuda_ms(
            lambda: bs.bone_splat_plain(uv, feat, size, distance), 5)
        nbytes = (uv.numel() * 4 + feat.numel() * 2
                  + b * size * size * 20 * c * 2)
        # about 40 fp32 operations per (pixel, bone) for the two weights,
        # 3 per output element
        flops = b * size * size * 20 * (40 + 3 * c)
        results.append({
            "shape": [b, size, c, distance], "max_abs_err": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            **bound(nbytes, flops, PEAK_FP32_FLOP_PER_S),
        })
        say(f"K5 {what}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {results[-1]['bound_ms']:.4f} ms "
            f"({results[-1]['bound_by']}); no library call computes it")
    return results


def epilogue_phase(ce):
    """The fused eval sites' pass (``bias_add_relu_kernel``) against its
    plain version at EPILOGUE_SHAPES: equal to the bit (both sum in fp32
    and round once), then timed in place on the conv output's buffer,
    beside the plain version and the byte bound. It replaces the eval BN,
    the add and the ReLU, which no single library call computes, so there
    is no library time."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cl = torch.channels_last

    def draw(shape):
        return torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=cl)

    results = {}
    for site, shape, has_z in EPILOGUE_SHAPES:
        y = draw(shape)
        z = draw(shape) if has_z else None
        bias = torch.randn(shape[1], generator=g, device=dev)
        want = ce.bias_add_relu_plain(y, bias, z)
        got = ce.bias_add_relu_(y.clone(), bias, z)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(
                f"bias_add_relu_kernel at {site} {shape}: "
                f"{int((got != want).sum())} elements differ from the "
                "plain version")
        del got, want
        buf = y.clone()
        ms = time_cuda_ms(lambda: ce.bias_add_relu_(buf, bias, z), 20)
        plain_ms = time_cuda_ms(
            lambda: ce.bias_add_relu_plain(y, bias, z), 5)
        n = y.numel()
        # y read and written, z read, in bf16; the bias once
        nbytes = 2 * n * (3 if has_z else 2) + 4 * shape[1]
        results[site] = {
            "shape": list(shape), "z": has_z, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **bound(nbytes, n * (3 if has_z else 2), PEAK_FP32_FLOP_PER_S),
        }
        say(f"bias_add_relu_kernel {site} {shape}{' + z' if has_z else ''}:"
            f" equal to the plain version; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {results[site]['bound_ms']:.4f} ms "
            f"({results[site]['bound_by']})")
        del y, z, buf
    return results


def check_outputs(out: dict, b: int) -> None:
    """Shapes and finiteness of every output of one request."""
    want = {"joint_xyz": (b, 21, 3), "mesh_xyz": (b, 778, 3),
            "joint_uv": (b, 21, 2), "mesh_uv": (b, 778, 2),
            "mano_para": (b, 64), "proj": (b, 3)}
    if len(out["stages"]) != 3:
        raise RuntimeError("expected 3 stages")
    for stage in out["stages"]:
        if tuple(stage["pd_offset"].shape) != (b, 3):
            raise RuntimeError("pd_offset shape")
        for key, shape in want.items():
            for side in ("left", "right"):
                t = stage[f"pd_{key}_{side}"]
                if tuple(t.shape) != shape or not torch.isfinite(t).all():
                    raise RuntimeError(f"pd_{key}_{side}: {tuple(t.shape)}")
        if not torch.isfinite(stage["pd_offset"]).all():
            raise RuntimeError("pd_offset not finite")
    for key in ("seg", "dense"):
        t = out[key]
        if tuple(t.shape) != (b, 32, 32, 3) or not torch.isfinite(t).all():
            raise RuntimeError(f"{key}: {tuple(t.shape)}")


def kernel_counts(mods) -> tuple:
    """Launches so far of (K1, K2, K3, K4, K5)."""
    fb, q8, st, bs = mods
    f = fb.fused_bottleneck_infer
    return (f.launches, f.streamed_launches,
            q8.fused_bottleneck_int8_infer.launches,
            st.fused_stem_bottleneck.launches, bs.bone_splat.launches)


def reset_counts(mods) -> None:
    fb, q8, st, bs = mods
    f = fb.fused_bottleneck_infer
    f.launches = f.streamed_launches = 0
    q8.fused_bottleneck_int8_infer.launches = 0
    st.fused_stem_bottleneck.launches = 0
    bs.bone_splat.launches = 0


def epilogue_counts() -> tuple:
    """Fused eval sites run and ``bias_add_relu_kernel`` launches so far."""
    from dir_tpu_torch.ops import conv_epilogue as ce
    return ce.conv_bias_relu.fused_runs, ce.bias_add_relu_.launches


def drive(mods, name: str, infer, images: dict):
    """The main path in configuration ``name``: the kernels' counts and the
    fused eval sites' (:func:`epilogue_counts`) set to 0, one request per
    batch size, the counts read; every output and the launches per request
    checked. Returns the outputs, the kernels' counts and the fused sites'
    pass's launches."""
    from dir_tpu_torch.ops import conv_epilogue as ce
    reset_counts(mods)
    ce.conv_bias_relu.fused_runs = ce.bias_add_relu_.launches = 0
    outputs, per_request, fused = {}, {}, {}
    for b in BATCHES:
        before, fused_before = kernel_counts(mods), epilogue_counts()
        outputs[b] = infer(images[b])
        torch.cuda.synchronize()
        per_request[b] = tuple(
            n - m for n, m in zip(kernel_counts(mods), before))
        fused[b] = tuple(
            n - m for n, m in zip(epilogue_counts(), fused_before))
    launches = kernel_counts(mods)
    say(f"main path, configuration {name}: launches per request of "
        f"{KERNELS} {per_request}, total {launches}; fused eval sites and "
        f"bias_add_relu_kernel launches per request {fused}")
    for b in BATCHES:
        check_outputs(outputs[b], b)
        if per_request[b] != EXPECTED[name]:
            raise RuntimeError(
                f"configuration {name}, batch {b}: {KERNELS} ran "
                f"{per_request[b]} times, expected {EXPECTED[name]}")
        if fused[b] != (EXPECTED_EPILOGUE[name],) * 2:
            raise RuntimeError(
                f"configuration {name}, batch {b}: {fused[b][0]} fused eval "
                f"sites and {fused[b][1]} launches of bias_add_relu_kernel, "
                f"expected {EXPECTED_EPILOGUE[name]} of each")
    return outputs, launches, epilogue_counts()[1]


def t_breaches(errs: dict) -> list:
    """The limits of REFERENCE_T_TOL that a train step's errors break."""
    worst = dict(errs, whole_grad_rel=max(errs["whole_grad_rel"].values()))
    return [k for k, tol in REFERENCE_T_TOL.items() if worst[k] > tol]


def reference_phase(mods):
    """The port on the card against dir_tpu's recorded outputs: the record's
    weights (the seeded draw, its digest checked, the conditioned BatchNorm
    statistics and MANO head biases loaded); fp32 A with TF32 off (no
    kernel: the guards send fp32 to the unfused blocks) to the fp32 record,
    once more with TF32 on for cuDNN as a negative control; bf16 A and B,
    int8 C on dir_tpu's recorded scales, each counted; one fp32 train step of
    T with K5, then a bf16 step and a one-row step as its negative
    controls. Raises on any breach. Returns the launches and the record of
    errors, bounds and seconds."""
    from dir_tpu_torch import reference as dir_reference
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.models.resnet import Bottleneck
    from dir_tpu_torch.serve import (CONFIG_B, CONFIG_C, flagship_mano,
                                     make_infer)
    from dir_tpu_torch.weights import load_amax

    t0 = time.monotonic()
    record = dir_reference.load(REFERENCE_RECORD)
    state = dir_reference.flagship_state(record)
    mano_l, mano_r = (m.to("cuda") for m in flagship_mano())
    img = dir_reference.images()
    say(f"reference: record {os.path.relpath(REFERENCE_RECORD, REPO)}, "
        f"{len(record)} arrays; the seeded weights' digest is the record's "
        f"({str(record['digest'])[:16]}...); {dir_reference.N_IMAGES} images")

    def model(dtype, **flags):
        m = DIR(ModelConfig(dtype=dtype, **dict(
            dict(fused_bottleneck_eval=True), **flags)))
        m.load_state_dict(state, strict=True)
        return m.to("cuda").eval()

    def counted(name, fn):
        reset_counts(mods)
        out = fn()
        torch.cuda.synchronize()
        launches = kernel_counts(mods)
        if launches != EXPECTED_REFERENCE[name]:
            raise RuntimeError(f"reference {name}: {KERNELS} ran {launches} "
                               f"times, expected {EXPECTED_REFERENCE[name]}")
        return out, launches

    result, launches = {}, {}
    # fp32 A, TF32 off (make_infer): what runs only on the card, held to
    # dir_tpu's fp32 outputs
    fp32 = model("float32")
    routed = Bottleneck.fp32_unfused_runs
    out, launches["fp32 A"] = counted(
        "fp32 A", lambda: make_infer(fp32, mano_l, mano_r)(img))
    routed = Bottleneck.fp32_unfused_runs - routed
    check_outputs(out, len(img))
    # fp32 A and its TF32 control are both held to A's record alone
    want_a = dir_reference.outputs(record, "A")
    first = dir_reference.first_moved(want_a)

    def against_a(out):
        return dir_reference.errors(dir_reference.flatten(out), want_a,
                                    first=first)

    errs = against_a(out)
    say(f"reference fp32 A (TF32 off, {routed} blocks routed unfused): max "
        f"abs err against dir_tpu's record {errs}; bounds "
        f"{REFERENCE_FP32_TOL}; by image, the first output a near-threshold "
        f"splat pair can move, left out (4: none): {first.tolist()}")
    result["fp32 A"] = {"max_abs_err": errs, "bounds": REFERENCE_FP32_TOL,
                        "launches": launches["fp32 A"],
                        "blocks_routed_unfused": routed,
                        "first_moved_by_image": first.tolist()}
    if routed != 2 or any(errs[k] > REFERENCE_FP32_TOL[k] for k in errs):
        raise RuntimeError("reference fp32 A: off dir_tpu's record")
    # bf16 with the kernels, to the fp32 records; C to C's record
    runs = (("bf16 A", "A", "bfloat16", {}, REFERENCE_BF16_MM),
            ("bf16 B", "B", "bfloat16", CONFIG_B, REFERENCE_BF16_MM),
            ("int8 C", "C", "bfloat16", CONFIG_C, REFERENCE_INT8_MM))
    for name, config, dtype, flags, bound_mm in runs:
        m = model(dtype, **flags)
        if config == "C":
            load_amax(m, dir_reference.amax(record))
        out, launches[name] = counted(
            name, lambda: make_infer(m, mano_l, mano_r)(img))
        check_outputs(out, len(img))
        got = dir_reference.flatten(out)
        want = dir_reference.outputs(record, config)
        mm = dir_reference.final_mm(got, want)
        errs = dir_reference.errors(got, want)
        heads = dir_reference.head_errors(got, want)
        say(f"reference {name}: final stage max abs err against dir_tpu's "
            f"{config} record {mm:.4f} mm (bound {bound_mm}); launches "
            f"{launches[name]}; max abs err by kind {errs}; seg/dense "
            f"{heads}")
        result[name] = {"final_mm": mm, "bound_mm": bound_mm,
                        "max_abs_err": errs, "heads": heads,
                        "launches": launches[name]}
        if mm > bound_mm:
            raise RuntimeError(f"reference {name}: {mm:.4f} mm off the record")
        if config == "C" and any(heads[k] > REFERENCE_INT8_HEADS[k]
                                 for k in heads):
            raise RuntimeError(f"reference {name}: seg/dense {heads} beyond "
                               f"{REFERENCE_INT8_HEADS}")
        del m, out

    # T: one fp32 step of the train path, K5 in the forward
    m = DIR(ModelConfig(dtype="float32", **dir_reference.T_FLAGS))
    m.load_state_dict(state, strict=True)
    (losses, grads), launches["T"] = counted(
        "T", lambda: dir_reference.train_step_gradients(
            m, mano_l, mano_r, dir_reference.train_batch(), "cuda"))
    errs = dir_reference.train_errors(record, losses, grads)
    say(f"reference T (fp32, one step, batch {dir_reference.TRAIN_BATCH}): "
        f"against dir_tpu's value_and_grad {errs}; bounds {REFERENCE_T_TOL}; "
        f"launches {launches['T']}")
    result["T"] = dict(errs, bounds=REFERENCE_T_TOL, launches=launches["T"])
    if t_breaches(errs):
        raise RuntimeError("reference T: off dir_tpu's gradients")
    del m, grads
    # T's negative controls: known-wrong steps must break T's bounds
    batch = dir_reference.train_batch()
    wrong = (("bf16 trunk", "bfloat16", batch),
             ("batch cut to one row", "float32",
              {k: v[:1] for k, v in batch.items()}))
    for name, dtype, rows in wrong:
        m = DIR(ModelConfig(dtype=dtype, **dir_reference.T_FLAGS))
        m.load_state_dict(state, strict=True)
        errs = dir_reference.train_errors(
            record, *dir_reference.train_step_gradients(
                m, mano_l, mano_r, rows, "cuda"))
        caught = t_breaches(errs)
        say(f"reference negative control, T with the {name}: {errs}; beyond "
            f"the bounds: {caught}")
        result[f"T, {name} control"] = dict(errs, beyond_bounds=caught)
        if not caught:
            raise RuntimeError(f"T's bounds do not catch the {name}")
        del m
    # the negative control, last: fp32 A again with TF32 on for cuDNN
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            out = fp32(torch.from_numpy(img).cuda(), mano_l, mano_r)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    control = against_a(out)
    caught = [k for k in control if control[k] > REFERENCE_FP32_TOL[k]]
    say(f"reference negative control, fp32 A with TF32 on for cuDNN: max abs "
        f"err {control}; beyond the bounds: {caught}")
    result["fp32 A, TF32 control"] = {"max_abs_err": control,
                                      "beyond_bounds": caught}
    if not caught:
        raise RuntimeError("the fp32 reference bounds do not catch TF32")
    del fp32, out
    torch.cuda.empty_cache()

    result["seconds"] = time.monotonic() - t0
    total = tuple(map(sum, zip(*launches.values())))
    return total, result


def serve_phase(mods):
    """Requests through the bf16 flagship in configurations A, B and C,
    checked against fp32."""
    from dir_tpu_torch.models import dir as dir_module
    from dir_tpu_torch.models import resnet as resnet_module
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.ops.quant import scale_from_amax
    from dir_tpu_torch.serve import (CONFIG_B, CONFIG_C, build_flagship,
                                     calibrate_static_scales,
                                     condition_random_, make_infer)
    from dir_tpu_torch.train import evaluate

    fb, q8, _, bs = mods
    model, cfg, mano_l, mano_r = build_flagship(
        device="cuda", dtype="bfloat16", fused_bottleneck_eval=True, seed=0)
    # random weights make the bf16-vs-fp32 comparison ill-conditioned
    # unless the MANO heads and BatchNorm statistics are set up first
    condition_random_(model, mano_l, mano_r, seed=0)

    def variant(**kw):
        m = DIR(dataclasses.replace(cfg, **kw))
        m.load_state_dict(model.state_dict(), strict=True)
        return m.to("cuda").eval()

    # configurations B and C on configuration A's weights: same state_dict
    models = {"A": model, "B": variant(**CONFIG_B), "C": variant(**CONFIG_C)}
    infers = {n: make_infer(m, mano_l, mano_r) for n, m in models.items()}
    rng = np.random.RandomState(0)
    images = {b: rng.randn(b, 256, 256, 3).astype(np.float32)
              for b in BATCHES}
    say(f"flagship built: backbone {cfg.backbone_layers}, dtype {cfg.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"configuration B = {CONFIG_B}; configuration C = {CONFIG_C}")

    # C's static scales: one calibration forward over a seeded batch of its
    # own, through the unfused int8 route (no K3 launch)
    reset_counts(mods)
    calibrate_static_scales(
        models["C"], np.random.RandomState(1).randn(
            CALIBRATION_BATCH, 256, 256, 3).astype(np.float32), mano_l,
        mano_r)
    torch.cuda.synchronize()
    if any(kernel_counts(mods)):
        raise RuntimeError(f"calibration launched {kernel_counts(mods)}")
    n_scales = sum(len(m.filled) for m in models["C"].modules()
                   if hasattr(m, "filled"))
    say(f"configuration C calibrated on {CALIBRATION_BATCH} seeded images: "
        f"{n_scales} activation scales, no kernel launched")

    # what the fused blocks and the splat received, kept from the last
    # request (batch 64): forward pre-hooks on the blocks, and a recording
    # wrapper in the place where the model looks the splat up
    blocks = {"A": {f"layer1_{i}": models["A"].backbone.layer1[i]
                    for i in (1, 2)},
              "B": {f"layer2_{i}": models["B"].backbone.layer2[i]
                    for i in (1, 2, 3)},
              "C": {"layer1_2 (int8)": models["C"].backbone.layer1[2],
                    "layer2_3 (int8)": models["C"].backbone.layer2[3]}}
    received, splats = {}, []
    hooks = [blk.register_forward_pre_hook(
        lambda _, args, name=name: received.__setitem__(name, args[0]))
        for group in blocks.values() for name, blk in group.items()]

    def recording_splat(uv, feat, size, distance):
        splats.append((uv, feat, size, distance))
        return bs.bone_splat(uv, feat, size, distance)

    outputs, launches, fused = {}, {}, {}
    outputs["A"], launches["A"], fused["A"] = drive(mods, "A", infers["A"],
                                                    images)
    dir_module.bone_splat = recording_splat
    try:
        outputs["B"], launches["B"], fused["B"] = drive(
            mods, "B", infers["B"], images)
    finally:
        dir_module.bone_splat = bs.bone_splat
    # each K3 block makes its operands on its first request and keeps them
    made = []
    real_operands = resnet_module.kernel_operands
    resnet_module.kernel_operands = (
        lambda *a, **k: made.append(1) or real_operands(*a, **k))
    try:
        outputs["C"], launches["C"], fused["C"] = drive(
            mods, "C", infers["C"], images)
    finally:
        resnet_module.kernel_operands = real_operands
    say(f"configuration C: K3 operands made {len(made)} times over "
        f"{len(BATCHES)} requests (5 blocks)")
    if len(made) != EXPECTED["C"][2]:
        raise RuntimeError(f"configuration C made K3's operands {len(made)} "
                           "times, not once per block")
    for h in hooks:
        h.remove()

    # the kernels against their plain versions on what the path fed them at
    # batch 64
    served_err = dict.fromkeys(KERNELS, 0.0)
    with torch.inference_mode():
        for name, group in blocks.items():
            for block_name, blk in group.items():
                x = received[block_name]
                if x.shape[0] != BATCHES[-1]:
                    raise RuntimeError(f"{block_name} received batch "
                                       f"{x.shape[0]}")
                xn = x.to(blk.dtype).permute(0, 2, 3, 1)
                what = (f"{block_name} at batch {BATCHES[-1]} (served "
                        "activations)")
                if name == "C":
                    scales = [scale_from_amax(getattr(blk.quant_stats, n))
                              for n in ("conv1_in", "conv2_in", "conv3_in")]
                    err = compare_int8(q8, xn, blk.folded_weights(), scales,
                                       what, blk.quant_fused_l2_bands
                                       if xn.shape[1] < 64 else 1)
                    key = "K3"
                else:
                    bands = K2_BANDS if name == "B" else 0
                    err, _ = compare(fb, xn, blk.folded_weights(), what, bands)
                    key = "K2" if bands else "K1"
                served_err[key] = max(served_err[key], err)
        if [t[0].shape[0] for t in splats[-4:]] != [BATCHES[-1]] * 4:
            raise RuntimeError("the last four splats are not batch "
                               f"{BATCHES[-1]}'s")
        for i, (uv, feat, size, distance) in enumerate(splats[-4:]):
            err = compare_splat(
                bs, uv, feat, size, distance,
                f"stage {i // 2 + 1} {'left' if i % 2 == 0 else 'right'} at "
                f"batch {BATCHES[-1]} (served joints, S {size}, distance "
                f"{distance})")
            served_err["K5"] = max(served_err["K5"], err)
        # the visualization map, where the model returns it
        vis = models["B"](torch.from_numpy(images[8]).cuda(), mano_l, mano_r,
                          want_vis=True)["vis_img_feat"]
        if tuple(vis.shape) != (8, 32, 32, 1280) or not torch.isfinite(vis).all():
            raise RuntimeError(f"vis_img_feat: {tuple(vis.shape)}")
    del received, splats, vis

    # the port's fp32 unfused forward on the same weights, TF32 off; the
    # bf16 unfused forward beside it shows what bf16 alone costs
    ref_infer = make_infer(variant(dtype="float32",
                                   fused_bottleneck_eval=False),
                           mano_l, mano_r)
    bf16_infer = make_infer(variant(fused_bottleneck_eval=False),
                            mano_l, mano_r)
    keys = ("pd_joint_xyz_left", "pd_joint_xyz_right",
            "pd_mesh_xyz_left", "pd_mesh_xyz_right")
    jregs = [evaluate.extended_j_regressor(m) for m in (mano_l, mano_r)]
    camera = torch.tensor([[500.0, 0, 128], [0, 500, 128], [0, 0, 1]],
                          device="cuda")
    depth = torch.tensor([0.0, 0.0, 0.5], device="cuda")
    worst = {n: {} for n in CONFIGS}
    metrics = {n: {} for n in CONFIGS}
    for b in BATCHES:
        ref = ref_infer(images[b])["stages"][-1]
        finals = {n: outputs[n][b]["stages"][-1] for n in CONFIGS}
        named = [("bf16 A", finals["A"]), ("bf16 B", finals["B"]),
                 ("int8 C", finals["C"]),
                 ("bf16 unfused", bf16_infer(images[b])["stages"][-1])]
        for name, fin in named:
            errs = {k: float((fin[k] - ref[k]).abs().max()) * 1e3
                    for k in keys}
            # mean per-joint error of the worst sample, both hands
            mpjpe = max(float((fin[k] - ref[k]).norm(dim=-1).mean(-1).max())
                        for k in keys[:2]) * 1e3
            say(f"batch {b}: {name} vs fp32, final stage max abs err "
                + ", ".join(f"{k[3:]} {v:.4f} mm" for k, v in errs.items())
                + f"; worst sample's mean joint err {mpjpe:.4f} mm")
            if name != "bf16 unfused":
                worst[name[-1]][b] = max(errs.values())
        for other in "BC":
            say(f"batch {b}: {other} vs A, final stage max abs diff "
                + ", ".join(
                    f"{k[3:]} "
                    f"{float((finals[other][k] - finals['A'][k]).abs().max()) * 1e3:.4f} mm"
                    for k in keys))
        # each configuration against the fp32 forward through the port's
        # metrics, the fp32 meshes standing in for the ground truth, 0.5 m
        # from the camera
        for name, fin in finals.items():
            acc = evaluate.batch_metrics(
                fin["pd_mesh_xyz_left"] + depth,
                fin["pd_mesh_xyz_right"] + depth, fin["pd_offset"],
                ref["pd_mesh_xyz_left"] + depth,
                ref["pd_mesh_xyz_right"] + depth,
                camera.expand(b, 3, 3), *jregs, torch.ones(b, device="cuda"))
            summary = evaluate.summarize({k: float(v) for k, v in acc.items()})
            metrics[name][b] = {"mpjpe_mm": summary["joint_mean_all_mm"],
                                "mpvpe_mm": summary["vert_mean_all_mm"]}
        say(f"batch {b}: vs fp32 through batch_metrics: " + "; ".join(
            f"{n} MPJPE {m[b]['mpjpe_mm']:.4f} mm, MPVPE "
            f"{m[b]['mpvpe_mm']:.4f} mm" for n, m in metrics.items()))
    for name in CONFIGS:
        limit = SERVE_TOL_MM_INT8 if name == "C" else SERVE_TOL_MM
        if max(worst[name].values()) > limit:
            raise RuntimeError(
                f"configuration {name}: off the fp32 forward by "
                f"{max(worst[name].values()):.4f} mm > {limit}")
    del ref_infer, bf16_infer

    # request latency on the host clock, image upload included; the host's
    # cores are shared, so the spread is printed beside the median
    latency = {n: {} for n in CONFIGS}
    for b in BATCHES:
        for name in CONFIGS:
            times = []
            for _ in range(LATENCY_REPS):
                t = time.perf_counter()
                infers[name](images[b])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            times.sort()
            latency[name][b] = times[len(times) // 2]
            say(f"batch {b}, configuration {name}: request latency median "
                f"{latency[name][b]:.3f} ms, min {times[0]:.3f}, max "
                f"{times[-1]:.3f} over {LATENCY_REPS} "
                f"({b / latency[name][b] * 1e3:.1f} img/s at the median)")
    live = {"models": models, "infers": infers, "images": images,
            "mano": (mano_l, mano_r)}
    return launches, fused, served_err, worst, latency, metrics, live


def batch_loss(model, batch, mano_l, mano_r) -> float:
    """The total train-mode loss of ``model`` on ``batch``, no gradient."""
    from dir_tpu_torch.models.losses import dir_losses, total_loss

    with torch.no_grad():
        out = model(batch["img"], mano_l, mano_r)
        return float(total_loss(dir_losses(
            out, batch, model.cfg, mano_l.faces, mano_r.faces,
            fused_stages=True)))


def train_run(mods, name, model, mano_l, mano_r, batch, steps: int):
    """``steps`` AdamW steps of ``model`` on the repeated ``batch`` through
    the port's train step, the kernels' counts set to 0 just before and read
    just after. Returns per step the host time around the step and a
    synchronise and the time between CUDA events recorded before and after
    it (ms), the total loss and the launches, the total launches and the
    peak memory; checks finite losses and moved, finite parameters."""
    from dir_tpu_torch.config import TrainConfig
    from dir_tpu_torch.models.losses import total_loss
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, model.cfg, mano_l, mano_r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts(mods)
    times, event_times, losses, per_step = [], [], [], []
    for _ in range(steps):
        before = kernel_counts(mods)
        t = time.perf_counter()
        start.record()
        state, loss_dict = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        event_times.append(start.elapsed_time(end))
        per_step.append(tuple(a - b for a, b in zip(kernel_counts(mods),
                                                    before)))
        losses.append(float(total_loss(loss_dict)))
    launches = kernel_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    if state.step != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"{name}: steps {state.step}, losses {losses}")
    moved = sum(not torch.equal(p, init[k])
                for k, p in model.named_parameters())
    if moved < 0.9 * len(init) or not all(
            torch.isfinite(p).all() for p in model.parameters()):
        raise RuntimeError(f"{name}: {moved} of {len(init)} parameters "
                           "moved, or a parameter is not finite")
    say(f"train {name}: batch {batch['img'].shape[0]}, {steps} steps, "
        f"ms per step {[round(t, 3) for t in times]} (CUDA events "
        f"{[round(t, 3) for t in event_times]}), losses "
        f"{[round(v, 6) for v in losses]}, launches per step of {KERNELS} "
        f"{per_step}, peak memory {peak / 2**30:.3f} GiB, {moved} of "
        f"{len(init)} parameters moved")
    return times, event_times, losses, per_step, launches, peak


def k5_training_check(mods, state_dict, mano_l, mano_r) -> dict:
    """K5's training route against the plain splat: the fp32 flagship with
    B's decoder flags in train mode, one state_dict and one batch, once with
    ``use_pallas_splat`` (K5 forward, plain backward) and twice without (the
    run-to-run spread of the plain route). Compares the loss and every
    parameter's gradient; counts the (pixel, bone) pairs K5 received near
    the threshold."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.device import deterministic
    from dir_tpu_torch.models import dir as dir_module
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.models.losses import dir_losses, total_loss
    from dir_tpu_torch.profile_serve import train_batch

    fb, q8, st, bs = mods
    batch = train_batch(K5_TRAIN_BATCH, seed=1)
    splats = []

    def recording_splat(uv, feat, size, distance):
        splats.append((uv.detach(), size, distance))
        return bs.bone_splat(uv, feat, size, distance)

    runs = {}
    for name, pallas in (("K5", True), ("plain", False),
                         ("plain again", False)):
        model = DIR(ModelConfig(dtype="float32", fused_splat_conv=False,
                                use_pallas_splat=pallas)).cuda()
        model.load_state_dict(state_dict, strict=True)
        model.train()
        before = bs.bone_splat.launches
        dir_module.bone_splat = recording_splat
        try:
            with deterministic():
                out = model(batch["img"], mano_l, mano_r)
                loss = total_loss(dir_losses(
                    out, batch, model.cfg, mano_l.faces, mano_r.faces,
                    fused_stages=True))
                loss.backward()
        finally:
            dir_module.bone_splat = bs.bone_splat
        torch.cuda.synchronize()
        if bs.bone_splat.launches - before != (4 if pallas else 0):
            raise RuntimeError(f"K5 training check ({name}): "
                               f"{bs.bone_splat.launches - before} launches")
        runs[name] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()
                                    if p.grad is not None})
        del model, out, loss

    def diff(a, b):
        """Run ``a`` against run ``b``: the loss's relative error and the
        worst gradient error, each tensor's over the larger of its own max
        |value| and GRAD_FLOOR of the largest of all (a conv bias feeding a
        train-mode BN has a gradient that is 0 in exact arithmetic: in fp32
        it is rounding noise)."""
        top = max(float(g.abs().max()) for g in b[1].values())
        worst = (0.0, None)
        for k, g in b[1].items():
            scale = max(float(g.abs().max()), GRAD_FLOOR * top)
            err = float((a[1][k] - g).abs().max()) / scale
            worst = max(worst, (err, k), key=lambda t: t[0])
        return abs(a[0] - b[0]) / abs(b[0]), worst

    k5 = diff(runs["K5"], runs["plain"])
    spread = diff(runs["plain again"], runs["plain"])
    near = [int(bs.threshold_pairs(uv, size, d).sum())
            for uv, size, d in splats]
    pairs = sum(uv.shape[0] * size * size * 20 for uv, size, _ in splats)
    say(f"K5 in training (fp32, batch {K5_TRAIN_BATCH}, full width): loss "
        f"{runs['plain'][0]:.6f}, K5 vs plain loss rel err {k5[0]:.3g}, worst "
        f"gradient err {k5[1][0]:.3g} ({k5[1][1]}) over "
        f"{len(runs['plain'][1])} tensors; plain vs plain again: loss "
        f"{spread[0]:.3g}, gradient "
        f"{spread[1][0]:.3g} ({spread[1][1]}); (pixel, bone) pairs within "
        f"{bs.THRESHOLD_MARGIN_PX} px of the threshold in K5's inputs: "
        f"{sum(near)} of {pairs}")
    if not (k5[0] <= K5_TRAIN_LOSS_RTOL and k5[1][0] <= K5_TRAIN_GRAD_RTOL):
        raise RuntimeError("K5's training route disagrees with the plain "
                           "splat")
    if spread[0] or spread[1][0]:
        raise RuntimeError("the plain route's forward and backward did not "
                           "repeat bit for bit under deterministic algorithms")
    return {"loss_rel_err": k5[0], "grad_rel_err": k5[1][0],
            "grad_rel_err_at": k5[1][1], "spread_loss_rel_err": spread[0],
            "spread_grad_rel_err": spread[1][0], "threshold_pairs": sum(near),
            "pairs": pairs}


def train_phase(mods):
    """Configuration T and the default decoder, trained on the card; K5's
    training route against the plain splat."""
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.profile_serve import train_batch
    from dir_tpu_torch.serve import CONFIG_B, build_flagship, condition_random_

    model, cfg, mano_l, mano_r = build_flagship(
        device="cuda", dtype="bfloat16", seed=0, **CONFIG_B)
    condition_random_(model, mano_l, mano_r, seed=0)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(TRAIN_BATCH)
    times, event_times, losses, per_step, launches, peak = train_run(
        mods, "T", model, mano_l, mano_r, batch, TRAIN_WARMUP + TRAIN_STEPS)
    for n in per_step:
        if n != EXPECTED["T"]:
            raise RuntimeError(f"configuration T: {KERNELS} ran {n} times a "
                               f"step, expected {EXPECTED['T']}")
    final = batch_loss(model, batch, mano_l, mano_r)
    say(f"train T: loss on the repeated batch after the last step {final:.6f}"
        f", first step's {losses[0]:.6f} (ratio {final / losses[0]:.4f})")
    if not final <= TRAIN_LOSS_RATIO * losses[0]:
        raise RuntimeError("configuration T: the loss did not fall")
    timed = sorted(times[TRAIN_WARMUP:])
    events = sorted(event_times[TRAIN_WARMUP:])
    result = {"T": {
        "batch": TRAIN_BATCH, "ms_per_step": timed[len(timed) // 2],
        "ms_per_step_min": timed[0], "ms_per_step_max": timed[-1],
        "event_ms_per_step": events[len(events) // 2],
        "peak_memory_bytes": peak, "losses": losses, "loss_after": final,
        "k5_launches_per_step": per_step[0][4]}}
    del model, batch

    # the default decoder (factored splat conv) on the same weights
    model = DIR(dataclasses.replace(cfg, fused_splat_conv=True,
                                    use_pallas_splat=False)).cuda()
    model.load_state_dict(state_dict, strict=True)
    batch = train_batch(TRAIN_BATCH)
    times, event_times, losses, per_step, _, peak = train_run(
        mods, "default decoder", model, mano_l, mano_r, batch,
        DEFAULT_DECODER_STEPS)
    if any(any(n) for n in per_step):
        raise RuntimeError(f"the default decoder launched {per_step}")
    result["default_decoder"] = {
        "batch": TRAIN_BATCH, "ms_per_step": times,
        "event_ms_per_step": event_times, "peak_memory_bytes": peak,
        "losses": losses}
    del model, batch
    torch.cuda.empty_cache()
    result["k5_training"] = k5_training_check(mods, state_dict, mano_l,
                                              mano_r)
    return launches, result


def states_equal(a: dict, b: dict) -> tuple:
    """Two host ``state_dict``s: the tensors that differ (bitwise) and the
    largest absolute difference over all."""
    differ, worst = [], 0.0
    for k, v in b.items():
        if not torch.equal(a[k], v):
            differ.append(k)
            worst = max(worst, float((a[k].double() - v.double()).abs().max()))
    return differ, worst


def losses_diff(a: list, b: list) -> float:
    """The largest absolute difference of any loss term over the steps."""
    return max(abs(x[k] - v) for x, y in zip(a, b) for k, v in y.items())


def upsample_tconv(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's other formulation of the 2x upsample
    (``_upsample2x_tconv``): an edge pad and a depthwise transposed
    convolution with the taps [0.25, 0.75, 0.75, 0.25], in cuDNN; a
    yardstick for ``layers.upsample2x``, which the port does not call."""
    n = x.permute(0, 3, 1, 2)
    n = torch.cat([n[:, :, :1], n, n[:, :, -1:]], 2)
    n = torch.cat([n[..., :1], n, n[..., -1:]], 3)
    taps = torch.tensor([0.25, 0.75, 0.75, 0.25], device=x.device)
    k = (taps[:, None] * taps[None, :]).to(x.dtype).expand(
        x.shape[-1], 1, 4, 4)
    out = F.conv_transpose2d(n, k, stride=2, padding=3, groups=x.shape[-1])
    return out.permute(0, 2, 3, 1)


def f2_op_times() -> dict:
    """The decoder's 2x upsample and joint sampling at their eval-batch-256
    shapes (bf16 maps), forward and forward plus backward to the maps:
    the port's forms against the library calls they replace (and the
    transposed-conv form of the upsample); ms by CUDA events, and each
    form's max abs difference from the port's."""
    from dir_tpu_torch.models.layers import upsample2x
    from dir_tpu_torch.ops.sampling import (grid_sample_nhwc,
                                            grid_sample_nhwc_mm)

    def interpolate(x):
        return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                             mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)

    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    cases = [("upsample", shape, {"port": upsample2x,
                                   "F.interpolate": interpolate,
                                   "tconv": upsample_tconv})
             for shape in F2_UPSAMPLE_SHAPES]
    cases += [("grid_sample", shape, {"port": grid_sample_nhwc_mm,
                                      "F.grid_sample": grid_sample_nhwc})
              for shape in F2_SAMPLE_SHAPES]
    for op, shape, forms in cases:
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        args = ()
        if op == "grid_sample":
            args = (torch.rand((shape[0], F2_POINTS, 2), device="cuda",
                               generator=g) * 2.2 - 1.1,)
        xg = x.detach().requires_grad_(True)
        ref = forms["port"](x, *args)
        grad = torch.randn(ref.shape, device="cuda", generator=g).to(ref.dtype)
        row = {}
        for name, fn in forms.items():
            y = fn(x, *args)

            def both(fn=fn):
                return torch.autograd.grad(fn(xg, *args), xg,
                                           grad.to(y.dtype))

            row[name] = {
                "ms": time_cuda_ms(lambda fn=fn: fn(x, *args), 20),
                "fwd_bwd_ms": time_cuda_ms(both, 20),
                "max_abs_diff": float((y.float() - ref.float()).abs().max())}
        out[f"{op} {tuple(shape)}"] = row
        say(f"F2 {op} at {tuple(shape)} (bf16): " + "; ".join(
            f"{n} {r['ms']:.4f} ms forward, {r['fwd_bwd_ms']:.4f} ms with "
            f"the backward, max abs diff from the port's "
            f"{r['max_abs_diff']:.3g}" for n, r in row.items()))
    return out


def f2_phase(mods) -> dict:
    """F2: configuration T's steps (full width, bf16, batch 64) twice from
    one state_dict through the port's train step, which runs under
    deterministic algorithms: losses, BN statistics and parameters must be
    bit-equal. The same steps with the deterministic mode patched out time
    what it costs; then the decoder's upsample and sampling forms."""
    import contextlib

    from dir_tpu_torch.profile_serve import train_batch
    from dir_tpu_torch.serve import CONFIG_B, build_flagship, condition_random_
    from dir_tpu_torch.train import steps as steps_module

    model, _, mano_l, mano_r = build_flagship(
        device="cuda", dtype="bfloat16", seed=0, **CONFIG_B)
    condition_random_(model, mano_l, mano_r, seed=0)
    state_dict = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    batch = {k: v.cpu() for k, v in train_batch(TRAIN_BATCH).items()}
    batches = [batch] * (TRAIN_WARMUP + F2_STEPS)
    runs = {}
    mode = steps_module.deterministic
    for name in ("first", "again", "without deterministic mode"):
        if name.startswith("without"):
            steps_module.deterministic = contextlib.nullcontext
        try:
            runs[name] = dp_steps(mods, state_dict, batches)
        finally:
            steps_module.deterministic = mode
        if any(n != EXPECTED["T"] for n in runs[name]["launches"]):
            raise RuntimeError(f"F2 ({name}): launches per step "
                               f"{runs[name]['launches']}")
    first, again = runs["first"], runs["again"]
    differ, worst = states_equal(again["state"], first["state"])
    loss_diff = losses_diff(again["losses"], first["losses"])
    stats = [k for k in first["state"] if "running" in k]
    stats_diff = max(float((again["state"][k] - first["state"][k]).abs().max())
                     for k in stats)
    result = {"steps": TRAIN_WARMUP + F2_STEPS, "warmup": TRAIN_WARMUP,
              "batch": TRAIN_BATCH, "loss_max_abs_diff": loss_diff,
              "bn_stats_max_abs_diff": stats_diff,
              "state_max_abs_diff": worst, "tensors_differing": len(differ),
              "losses": [sum(d.values()) for d in first["losses"]]}
    for name, run in runs.items():
        timed = sorted(run["ms"][TRAIN_WARMUP:])
        result[name] = {"ms_per_step": run["ms"],
                        "ms_per_step_median": timed[len(timed) // 2]}
    say(f"F2: T at batch {TRAIN_BATCH}, {TRAIN_WARMUP} warm-up + {F2_STEPS} "
        f"steps twice from one state_dict under deterministic algorithms: "
        f"max difference of the loss terms {loss_diff}, of the BN "
        f"statistics {stats_diff}, of all {len(first['state'])} tensors "
        f"{worst} ({len(differ)} differ); ms per step "
        f"{[round(v, 3) for v in first['ms']]} and "
        f"{[round(v, 3) for v in again['ms']]} (medians "
        f"{result['first']['ms_per_step_median']:.3f}, "
        f"{result['again']['ms_per_step_median']:.3f}); without the "
        f"deterministic mode "
        f"{[round(v, 3) for v in runs['without deterministic mode']['ms']]}"
        f" (median "
        f"{result['without deterministic mode']['ms_per_step_median']:.3f})")
    if differ or loss_diff != 0.0:
        raise RuntimeError("F2: the same steps from one state did not "
                           "repeat bit for bit")
    del runs, first, again
    torch.cuda.empty_cache()
    result["ops"] = f2_op_times()
    return result


def _instrument(mods, trainer, record: dict, fed: dict):
    """Wrap the trainer's train and eval steps and its on-device
    preprocessing: each call's host time (to a synchronise), its kernel
    launches and, for steps, the total loss go into ``record``;
    ``fed["on"]`` is true while an eval step runs."""
    def wrap(kind, fn):
        def call(*args):
            before = kernel_counts(mods)
            t = time.perf_counter()
            fed["on"] = kind == "eval"
            try:
                out = fn(*args)
                torch.cuda.synchronize()
            finally:
                fed["on"] = False
            entry = {"ms": (time.perf_counter() - t) * 1e3,
                     "launches": tuple(a - b for a, b in
                                       zip(kernel_counts(mods), before))}
            if kind == "train":
                entry["loss"] = float(sum(torch.stack(
                    list(out[1].values())).double().cpu().tolist()))
            record[kind].append(entry)
            return out
        return call

    trainer.train_step = wrap("train", trainer.train_step)
    trainer.eval_step = wrap("eval", trainer.eval_step)
    if trainer.preprocess_train is not None:
        trainer.preprocess_train = wrap("preprocess",
                                        trainer.preprocess_train)


def write_split(data_dir: str, mano_l, mano_r) -> None:
    """The Trainer's synthetic split (TRAINER_TRAIN train, TRAINER_TEST
    test samples at 256x256), written by the port's writer."""
    from dir_tpu_torch.data import synthetic

    t = time.monotonic()
    ml_cpu, mr_cpu = mano_l.to("cpu"), mano_r.to("cpu")
    synthetic.generate(data_dir, ml_cpu, mr_cpu, split="train",
                       num_samples=TRAINER_TRAIN, seed=0)
    synthetic.generate(data_dir, ml_cpu, mr_cpu, split="test",
                       num_samples=TRAINER_TEST, seed=1)
    say(f"trainer: synthetic split written ({TRAINER_TRAIN} train, "
        f"{TRAINER_TEST} test, 256x256) in {time.monotonic() - t:.1f} s")


def trainer_phase(mods):
    """The Trainer on the card: configuration T's model through
    make_data/make_model/train with the device pipeline (an epoch, a resume
    for a second, the same two epochs in one go), then an epoch on the host
    path; every step's and eval batch's
    launches checked; K1, K2 and K5 held against their plain versions on
    what the last in-loop eval fed them."""
    from dir_tpu_torch.config import Config, DataConfig, TrainConfig
    from dir_tpu_torch.models import dir as dir_module
    from dir_tpu_torch.serve import (CONFIG_B, build_flagship,
                                     condition_random_)
    from dir_tpu_torch.train import checkpoint as ckpt
    from dir_tpu_torch.train.trainer import AUG_STATE_KEY, Trainer

    fb, _, _, bs = mods
    root = os.path.join(REPO, "build", "chip_smoke_trainer")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    model, model_cfg, mano_l, mano_r = build_flagship(
        device="cuda", dtype="bfloat16", seed=0, **CONFIG_B)
    condition_random_(model, mano_l, mano_r, seed=0)
    state_dict = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    write_split(data_dir, mano_l, mano_r)

    def config(out, epochs, **data):
        return Config(
            model=model_cfg,
            data=DataConfig(data_dir=data_dir, img_size=256, num_workers=4,
                            **data),
            train=TrainConfig(batch_size=TRAIN_BATCH, total_epochs=epochs,
                              print_every=1, draw_every=0,
                              eval_every_epochs=1,
                              output_dir=os.path.join(root, out)))

    record = {"train": [], "eval": [], "preprocess": [], "summaries": []}
    fed = {"on": False}
    splats = collections.deque(maxlen=4)
    received = {}
    blocks = {}

    def trainer_for(cfg):
        tr = Trainer(cfg, mano_l, mano_r, device="cuda")
        tr.make_data()
        tr.make_model(init_state_dict=state_dict)
        _instrument(mods, tr, record, fed)
        blocks.clear()
        blocks.update({f"layer1_{i}": tr.model.backbone.layer1[i]
                       for i in (1, 2)})
        blocks.update({f"layer2_{i}": tr.model.backbone.layer2[i]
                       for i in (1, 2, 3)})
        for name, blk in blocks.items():
            blk.register_forward_pre_hook(
                lambda _, args, name=name: keep(name, args[0]))
        real_evaluate = tr.evaluate

        def evaluate(*args, **kw):
            record["summaries"].append(real_evaluate(*args, **kw))
            return record["summaries"][-1]

        tr.evaluate = evaluate
        return tr

    def keep(name, x):
        if fed["on"]:
            received[name] = x

    def recording_splat(uv, feat, size, distance):
        if fed["on"]:
            splats.append((uv, feat, size, distance))
        return bs.bone_splat(uv, feat, size, distance)

    runs = {}
    dir_module.bone_splat = recording_splat
    reset_counts(mods)
    try:
        for name, cfg, resume in (
                ("device pipeline", config("out", TRAINER_EPOCHS,
                                           device_pipeline=True), False),
                ("resumed", config("out", TRAINER_RESUMED_EPOCHS,
                                   device_pipeline=True), True),
                ("uninterrupted", config("out_whole", TRAINER_RESUMED_EPOCHS,
                                         device_pipeline=True), False),
                ("host path (wire8)", config("out_host", 1, wire8=True),
                 False)):
            if resume:
                first_best = runs["device pipeline"]["best"]
                first_state = runs["device pipeline"]["generator_state"]
                cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                    cfg.train, continue_train=True,
                    checkpoint=os.path.join(root, "out", "checkpoint")))
            n_train, n_eval, n_pre = (len(record[k]) for k in
                                      ("train", "eval", "preprocess"))
            tr = trainer_for(cfg)
            if resume:
                state = tr.aug_generator.get_state()
                ok = (tr.start_epoch == TRAINER_EPOCHS
                      and tr.state.step == TRAINER_EPOCHS * 2
                      and tr.best == first_best
                      and torch.equal(state, first_state))
                say(f"trainer resumed: start epoch {tr.start_epoch}, step "
                    f"{tr.state.step}, best {tr.best:.6f} (first run "
                    f"{first_best:.6f}), generator state equal "
                    f"{torch.equal(state, first_state)}")
                if not ok:
                    raise RuntimeError("the resumed Trainer did not restore "
                                       "epoch, step, best and generator")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            best = tr.train()
            seconds = time.perf_counter() - t
            runs[name] = {
                "best": best, "seconds": seconds,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "steps": record["train"][n_train:],
                "evals": record["eval"][n_eval:],
                "preprocess": record["preprocess"][n_pre:],
                "epoch_stats": list(tr.epoch_stats),
                "state": {k: v.detach().cpu().clone() for k, v in
                          ckpt.model_state_dict(tr.model).items()}}
            if hasattr(tr, "aug_generator"):
                runs[name]["generator_state"] = tr.aug_generator.get_state()
                with open(os.path.join(cfg.train.output_dir, "checkpoint",
                                       "meta.json")) as f:
                    meta = json.load(f)
                if meta[AUG_STATE_KEY] != runs[name][
                        "generator_state"].tolist():
                    raise RuntimeError("meta.json's generator state")
            del tr
            torch.cuda.empty_cache()
    finally:
        dir_module.bone_splat = bs.bone_splat
    launches = kernel_counts(mods)

    # the resumed Trainer against the one that ran its epochs in one go
    differ, worst = states_equal(runs["resumed"]["state"],
                                 runs["uninterrupted"]["state"])
    stats = [k for k in runs["resumed"]["state"] if "running" in k]
    say(f"trainer: resumed after epoch {TRAINER_EPOCHS} against "
        f"uninterrupted, {TRAINER_RESUMED_EPOCHS} epochs each: "
        f"{len(differ)} of {len(runs['resumed']['state'])} tensors differ "
        f"({sum(k in stats for k in differ)} of {len(stats)} BN statistics),"
        f" max abs difference {worst}; best {runs['resumed']['best']:.6f} "
        f"and {runs['uninterrupted']['best']:.6f}")
    if differ or runs["resumed"]["best"] != runs["uninterrupted"]["best"]:
        raise RuntimeError("the resumed Trainer differs from the "
                           "uninterrupted one")
    for run in runs.values():
        del run["state"]

    result = {"batch": TRAIN_BATCH, "train_samples": TRAINER_TRAIN,
              "test_samples": TRAINER_TEST, "runs": {},
              "resumed_equals_uninterrupted": {
                  "tensors_differing": len(differ),
                  "max_abs_diff": worst}}
    for name, run in runs.items():
        steps, evals = run["steps"], run["evals"]
        for e in steps:
            if e["launches"] != EXPECTED["T"]:
                raise RuntimeError(f"trainer ({name}): a step launched "
                                   f"{e['launches']} of {KERNELS}")
            if not np.isfinite(e["loss"]):
                raise RuntimeError(f"trainer ({name}): loss {e['loss']}")
        for e in run["preprocess"]:
            if any(e["launches"]):
                raise RuntimeError(f"trainer ({name}): the preprocessing "
                                   f"launched {e['launches']} of {KERNELS}")
        for e in evals:
            if e["launches"] != EXPECTED_TRAINER_EVAL:
                raise RuntimeError(f"trainer ({name}): an eval batch "
                                   f"launched {e['launches']} of {KERNELS}")
        n_steps = sum(s["steps"] for s in run["epoch_stats"])
        loop_s = sum(s["seconds"] for s in run["epoch_stats"])
        wait_s = sum(s["loader_wait_seconds"] for s in run["epoch_stats"])
        if n_steps != len(steps) or len(evals) != len(run["epoch_stats"]):
            raise RuntimeError(f"trainer ({name}): {len(steps)} steps, "
                               f"{len(evals)} eval batches recorded")
        step_ms = sorted(e["ms"] for e in steps)
        summary = {
            "steps": n_steps, "eval_batches": len(evals),
            "ms_per_iteration": loop_s / n_steps * 1e3,
            "loader_wait_ms_per_step": wait_s / n_steps * 1e3,
            "loader_wait_share": wait_s / loop_s,
            "step_ms": [e["ms"] for e in steps],
            "step_ms_median": step_ms[len(step_ms) // 2],
            "preprocess_ms": [e["ms"] for e in run["preprocess"]],
            "eval_batch_ms": [e["ms"] for e in evals],
            "losses": [e["loss"] for e in steps],
            "best_joint_mean_all_mm": run["best"],
            "seconds": run["seconds"],
            "peak_memory_bytes": run["peak_memory_bytes"],
            "launches_per_step": list(steps[0]["launches"]),
            "launches_per_eval_batch": list(evals[0]["launches"])}
        result["runs"][name] = summary
        say(f"trainer {name}: {n_steps} steps, ms per iteration (loader, "
            "preprocessing, step, loss read) "
            f"{summary['ms_per_iteration']:.3f}"
            f", of it waiting on the loader "
            f"{summary['loader_wait_ms_per_step']:.3f} ms a step (share "
            f"{summary['loader_wait_share']:.4f}); on-device preprocessing ms "
            f"{[round(v, 3) for v in summary['preprocess_ms']]}; train step "
            f"ms {[round(v, 3) for v in summary['step_ms']]}; eval batch ms "
            f"{[round(v, 3) for v in summary['eval_batch_ms']]}; losses "
            f"{[round(v, 6) for v in summary['losses']]}; launches of "
            f"{KERNELS} per step {steps[0]['launches']}, per eval batch "
            f"{evals[0]['launches']}; best joint_mean_all_mm "
            f"{run['best']:.4f}; peak memory "
            f"{run['peak_memory_bytes'] / 2**30:.3f} GiB")
    summary = record["summaries"][-1]
    say("trainer: the last in-loop summary (host path): " + ", ".join(
        f"{k} {v:.4f}" for k, v in summary.items()))
    result["inloop_summaries"] = record["summaries"]
    say(f"trainer: launches of {KERNELS} over the three runs {launches}")

    # the kernels against their plain versions on the last in-loop eval's
    # inputs (the host-path run's)
    fed_err = dict.fromkeys(KERNELS, 0.0)
    with torch.inference_mode():
        for name in sorted(blocks):
            blk = blocks[name]
            x = received[name]
            if x.shape[0] != TRAIN_BATCH:
                raise RuntimeError(f"{name} received batch {x.shape[0]}")
            xn = x.to(blk.dtype).permute(0, 2, 3, 1)
            bands = K2_BANDS if name.startswith("layer2") else 0
            err, _ = compare(fb, xn, blk.folded_weights(),
                             f"{name} (in-loop eval activations)", bands)
            key = "K2" if bands else "K1"
            fed_err[key] = max(fed_err[key], err)
        for i, (uv, feat, size, distance) in enumerate(splats):
            err = compare_splat(
                bs, uv, feat, size, distance,
                f"stage {i // 2 + 1} {'left' if i % 2 == 0 else 'right'} "
                f"(in-loop eval joints, S {size}, distance {distance})")
            fed_err["K5"] = max(fed_err["K5"], err)
    result["fed_max_abs_err"] = {k: fed_err[k] for k in ("K1", "K2", "K5")}
    for name in os.listdir(root):      # the split stays for the train CLI
        if name != "data":
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return launches, fed_err, result


def dp_batch(i: int) -> dict:
    """The ``i``-th global batch of the data-parallel phase, on the host."""
    from dir_tpu_torch.profile_serve import train_batch

    return train_batch(TRAIN_BATCH, seed=DP_SEED + i, device="cpu")


def dp_config():
    """Configuration T's model configuration: bf16 trunk, B's flags (those
    of ``serve.build_flagship(**CONFIG_B)``)."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.serve import CONFIG_B

    return ModelConfig(dtype="bfloat16", fused_bottleneck_eval=True,
                       **CONFIG_B)


def dp_model(state_dict):
    """Configuration T's model on ``state_dict``, on the card."""
    from dir_tpu_torch.models.dir import DIR

    model = DIR(dp_config()).cuda()
    model.load_state_dict(state_dict, strict=True)
    return model


def dp_steps(mods, state_dict, batches, mesh=None, snapshot_at=None):
    """AdamW steps of T on ``batches`` (global; under ``mesh`` this rank's
    block of each), through ``make_train_step(mesh=...)``. Returns per step
    the global loss dict, the host ms to a synchronise and the launches,
    and the model's state after ``snapshot_at`` steps and at the end (on
    the host)."""
    from dir_tpu_torch.config import TrainConfig
    from dir_tpu_torch.parallel.mesh import shard_batch
    from dir_tpu_torch.serve import flagship_mano
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    mano_l, mano_r = flagship_mano()
    model = dp_model(state_dict)
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, model.cfg, mano_l, mano_r,
                           mesh=mesh)
    out = {"losses": [], "ms": [], "launches": [], "lr": []}
    for i, batch in enumerate(batches):
        block = (shard_batch(batch, mesh) if mesh is not None else
                 {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        before = kernel_counts(mods)
        t = time.perf_counter()
        state, loss = step(state, block)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["launches"].append(tuple(a - b for a, b in zip(
            kernel_counts(mods), before)))
        out["losses"].append({k: float(v) for k, v in loss.items()})
        # a float: the one-device step keeps each lr as a device tensor
        out["lr"].append(float(opt.param_groups[0]["lr"]))
        if i + 1 == snapshot_at:
            out["snapshot"] = {k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()}
    out["state"] = {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}
    del model, opt, state, step
    torch.cuda.empty_cache()
    return out


def dp_errors(got: dict, want: dict, lr: float, params: set) -> dict:
    """Two states of T (host ``state_dict``s; ``params`` names the
    parameters among their keys): the worst BN statistic of each tensor's
    max and the worst parameter element in units of ``lr``."""
    errs = {"stats": 0.0, "param_lr": 0.0}
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        d = float((got[k].double() - w.double()).abs().max())
        if k in params:
            errs["param_lr"] = max(errs["param_lr"], d / lr)
        else:
            errs["stats"] = max(errs["stats"],
                                d / max(float(w.abs().max()), 1e-30))
    return errs


def dp_loss_err(got: list, want: list) -> float:
    """The worst relative error of any loss term over the steps' loss
    dicts."""
    return max(abs(g[k] - v) / max(abs(v), 1e-30)
               for g, w in zip(got, want) for k, v in w.items())


def _digest(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _dp_rank(rank: int, port: int, world: int, backend: str,
             state_path: str, out_path: str) -> None:
    """One rank of (b), ``world`` ranks over ``backend`` on this host's
    card(s): T's steps on the rank's block of each global batch; writes the
    steps' record, the state's hash and, on rank 0, the state."""
    sys.path.insert(0, REPO)
    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dir_tpu_torch.ops import bone_splat as bs
    from dir_tpu_torch.ops import fused_bottleneck as fb
    from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
    from dir_tpu_torch.ops import fused_stem_bottleneck as st
    from dir_tpu_torch.parallel import mesh as pmesh

    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    pmesh.init_distributed(f"127.0.0.1:{port}", world, rank,
                           backend=backend, device="cuda",
                           timeout=DP_TIMEOUT)
    try:
        mesh = pmesh.make_mesh(world)
        mods = (fb, q8, st, bs)
        reset_counts(mods)
        run = dp_steps(mods, torch.load(state_path, weights_only=True),
                       [dp_batch(i) for i in range(DP_STEPS)], mesh)
        record = {k: run[k] for k in ("losses", "ms", "launches", "lr")}
        record.update(backend=dist.get_backend(), device=str(mesh.device),
                      digest=_digest(run["state"]),
                      peak_memory_bytes=torch.cuda.max_memory_allocated())
        if rank == 0:
            torch.save(run["state"], out_path + ".state.pt")
        with open(out_path, "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()


def _dp_cli_rank(rank: int, port: int, world: int, argv: list,
                 out_path: str) -> None:
    """One rank of the two-rank train app, started as torchrun starts one
    (its environment, then ``apps/train.py``'s main): each train and eval
    step's launches and the in-loop summaries are recorded."""
    sys.path.insert(0, REPO)
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    from dir_tpu_torch.apps import train as train_app
    from dir_tpu_torch.ops import bone_splat as bs
    from dir_tpu_torch.ops import fused_bottleneck as fb
    from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
    from dir_tpu_torch.ops import fused_stem_bottleneck as st
    from dir_tpu_torch.train.trainer import Trainer

    mods = (fb, q8, st, bs)
    record = {"train": [], "eval": [], "preprocess": [], "summaries": []}
    fed = {"on": False}
    make_model = Trainer.make_model

    def instrumented(self, *args, **kw):
        make_model(self, *args, **kw)
        _instrument(mods, self, record, fed)
        real_evaluate = self.evaluate

        def evaluate(*a, **k):
            record["summaries"].append(real_evaluate(*a, **k))
            return record["summaries"][-1]

        self.evaluate = evaluate

    Trainer.make_model = instrumented
    reset_counts(mods)
    best = train_app.main(argv)
    record["best"] = best
    record["launches"] = kernel_counts(mods)
    with open(out_path, "w") as f:
        json.dump(record, f)


def _dp_eval_rank(rank: int, port: int, world: int, argv: list,
                  out_path: str) -> None:
    """One rank of the data-parallel eval app, started as torchrun starts
    one: ``apps/eval.py``'s main; writes its summary (rank 0's) and the
    kernels' launches in this rank."""
    sys.path.insert(0, REPO)
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    from dir_tpu_torch.apps import eval as eval_app
    from dir_tpu_torch.ops import bone_splat as bs
    from dir_tpu_torch.ops import fused_bottleneck as fb
    from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
    from dir_tpu_torch.ops import fused_stem_bottleneck as st

    mods = (fb, q8, st, bs)
    reset_counts(mods)
    summary = eval_app.main(argv)
    with open(out_path, "w") as f:
        json.dump({"summary": summary, "launches": kernel_counts(mods)}, f)


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_ranks(target, world: int, args_of_rank) -> None:
    """Start ``world`` spawned processes running ``target(rank, port,
    world, *args_of_rank(rank))``; wait at most DP_TIMEOUT; a rank that
    fails, or the time running out, stops them all and raises."""
    import multiprocessing as mp

    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, port, world, *args_of_rank(r)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise RuntimeError("data-parallel ranks ran out of time")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"data-parallel ranks exited with {codes}")


def dp_phase(mods, world: int = 2, backend: str = "gloo"):
    """Data parallelism on the card: (a) configuration T's steps through a
    mesh of one NCCL rank against the same steps without a mesh; (b)
    ``world`` ranks over ``backend`` (on one card: two gloo ranks sharing
    it) against the single process on the same global batches; then the
    train app's main in as many ranks for an epoch of the Trainer phase's
    split with the device pipeline, its in-loop eval against one rank's on
    the same weights."""
    import torch.distributed as dist

    from dir_tpu_torch.config import Config, DataConfig, TrainConfig
    from dir_tpu_torch.parallel import mesh as pmesh
    from dir_tpu_torch.serve import CONFIG_B, build_flagship, condition_random_
    from dir_tpu_torch.train import checkpoint as ckpt
    from dir_tpu_torch.train.trainer import Trainer

    root = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    model, _, mano_l, mano_r = build_flagship(
        device="cuda", dtype="bfloat16", seed=0, **CONFIG_B)
    condition_random_(model, mano_l, mano_r, seed=0)
    state_dict = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    params = {k for k, _ in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    state_path = os.path.join(root, "state.pt")
    torch.save(state_dict, state_path)
    n = DP_WARMUP + DP_STEPS
    batches = [dp_batch(i) for i in range(n)]
    result = {}

    # the single process: the reference, the same steps again, and the
    # first steps with the batches' halves swapped
    reset_counts(mods)
    ref = dp_steps(mods, state_dict, batches, snapshot_at=DP_STEPS)
    again = dp_steps(mods, state_dict, batches, snapshot_at=DP_STEPS)
    swapped = dp_steps(mods, state_dict, [
        {k: torch.cat([v[TRAIN_BATCH // 2:], v[:TRAIN_BATCH // 2]])
         for k, v in b.items()} for b in batches[:DP_STEPS]])

    def against_ref(losses, state, steps):
        """``dp_errors`` and the worst loss term after ``steps`` steps."""
        want = ref["state"] if steps == n else ref["snapshot"]
        errs = dp_errors(state, want, ref["lr"][steps - 1], params)
        errs["loss"] = dp_loss_err(losses, ref["losses"][:steps])
        return errs

    repeat_n = against_ref(again["losses"], again["state"], n)
    repeat_b = against_ref(again["losses"][:DP_STEPS], again["snapshot"],
                           DP_STEPS)
    reorder_b = against_ref(swapped["losses"], swapped["state"], DP_STEPS)

    def bounds(*spreads):
        return {k: max([DP_SPREAD_FACTOR * sp[k] for sp in spreads]
                       + [DP_FLOORS[k]]) for k in DP_FLOORS}

    def within(errs, bound):
        return all(errs[k] <= bound[k] for k in bound)

    # (a) one NCCL rank
    t = time.monotonic()
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                           device="cuda", timeout=DP_TIMEOUT)
    try:
        mesh = pmesh.make_mesh(1)
        a_backend = dist.get_backend()
        reset_counts(mods)
        a = dp_steps(mods, state_dict, batches, mesh=mesh)
        launches_a = kernel_counts(mods)
    finally:
        dist.destroy_process_group()
    a_errs = against_ref(a["losses"], a["state"], n)
    a_bounds = bounds(repeat_n)
    timed = sorted(a["ms"][DP_WARMUP:])
    ref_timed = sorted(ref["ms"][DP_WARMUP:])
    say(f"dp (a): backend {a_backend}, a world of {mesh.world} on "
        f"{mesh.device}: T at batch {TRAIN_BATCH}, {n} steps "
        f"({DP_WARMUP} warm-up): ms per step {[round(v, 3) for v in a['ms']]}"
        f" (median of the timed {timed[len(timed) // 2]:.3f}; without a "
        f"mesh {ref_timed[len(ref_timed) // 2]:.3f}); launches per step of "
        f"{KERNELS} {a['launches']}; against the same steps without a mesh "
        f"{a_errs} (worst loss term relative, BN statistics of their max, "
        f"parameters in lr); the steps without a mesh repeated {repeat_n}; "
        f"bounds {a_bounds}; {time.monotonic() - t:.1f} s")
    if any(x != EXPECTED["T"] for x in a["launches"]):
        raise RuntimeError(f"dp (a): launches per step {a['launches']}")
    if not within(a_errs, a_bounds):
        raise RuntimeError("dp (a): a world of 1 differs from no mesh "
                           "beyond the run-to-run spread")
    # the train step is deterministic, so a world of 1 is the mesh-less
    # step to the bit, and so is the mesh-less step repeated
    a_differ, a_worst = states_equal(a["state"], ref["state"])
    a_loss = losses_diff(a["losses"], ref["losses"])
    again_differ, _ = states_equal(again["state"], ref["state"])
    say(f"dp (a) exact: against the steps without a mesh, {len(a_differ)} "
        f"of {len(ref['state'])} tensors differ (max abs difference "
        f"{a_worst}), loss terms {a_loss}; the steps without a mesh "
        f"repeated: {len(again_differ)} differ")
    if a_differ or a_loss or again_differ:
        raise RuntimeError("dp (a): a world of 1 is not bit-equal to the "
                           "steps without a mesh")
    result["a"] = {"backend": a_backend, "world": mesh.world,
                   "ms_per_step": a["ms"],
                   "ms_per_step_median": timed[len(timed) // 2],
                   "no_mesh_ms_per_step": ref["ms"],
                   "launches_per_step": a["launches"], "errors": a_errs,
                   "repeat_spread": repeat_n, "bounds": a_bounds,
                   "bit_equal": True}
    del a, again

    # (b) two gloo ranks on the card
    t = time.monotonic()
    outs = [os.path.join(root, f"rank{r}.json") for r in range(world)]
    _spawn_ranks(_dp_rank, world,
                 lambda r: (backend, state_path, outs[r]))
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    rank_state = torch.load(outs[0] + ".state.pt", weights_only=True)
    b_errs = against_ref(ranks[0]["losses"], rank_state, DP_STEPS)
    b_errs["loss"] = max(dp_loss_err(r["losses"], ref["losses"][:DP_STEPS])
                         for r in ranks)
    b_bounds = bounds(repeat_b, reorder_b)
    identical = len({r["digest"] for r in ranks}) == 1
    launches_b = tuple(sum(sum(x[i] for x in r["launches"]) for r in ranks)
                       for i in range(len(KERNELS)))
    shared = len({r["device"] for r in ranks}) < world
    say(f"dp (b): backend {ranks[0]['backend']}, {world} ranks on "
        f"{[r['device'] for r in ranks]}"
        + (" (cards shared: the step times are processes time-slicing a "
           "card, no multi-card step)" if shared else "")
        + f": global batch {TRAIN_BATCH}, {TRAIN_BATCH // world} a rank, "
        f"{DP_STEPS} steps; "
        f"ms per step by rank {[[round(v, 1) for v in r['ms']] for r in ranks]}"
        f"; launches per rank per step of {KERNELS} "
        f"{[r['launches'] for r in ranks]}; global loss dicts' totals "
        f"{[[round(sum(d.values()), 6) for d in r['losses']] for r in ranks]}"
        f" (single process {[round(sum(d.values()), 6) for d in ref['losses'][:DP_STEPS]]});"
        f" against the single process {b_errs}; the single process "
        f"repeated {repeat_b}, with the halves swapped {reorder_b}; bounds "
        f"{b_bounds}; ranks' parameters and buffers bit-identical "
        f"{identical}; peak memory by rank "
        f"{[round(r['peak_memory_bytes'] / 2**30, 3) for r in ranks]} GiB; "
        f"{time.monotonic() - t:.1f} s")
    for r in ranks:
        if any(tuple(x) != EXPECTED["T"] for x in r["launches"]):
            raise RuntimeError(f"dp (b): launches per step {r['launches']}")
    if not identical or not within(b_errs, b_bounds):
        raise RuntimeError("dp (b): two ranks differ from the single "
                           "process beyond the bounds")
    result["b"] = {"backend": ranks[0]["backend"], "world": world,
                   "devices": [r["device"] for r in ranks],
                   "cards_shared": shared,
                   "losses": [r["losses"] for r in ranks],
                   "single_process_losses": ref["losses"][:DP_STEPS],
                   "ms_per_step": [r["ms"] for r in ranks],
                   "launches_per_step": [r["launches"] for r in ranks],
                   "errors": b_errs, "repeat_spread": repeat_b,
                   "reorder_spread": reorder_b, "bounds": b_bounds,
                   "bit_identical": identical,
                   "peak_memory_bytes": [r["peak_memory_bytes"]
                                         for r in ranks]}
    del rank_state, ref, swapped

    # the train app in two gloo ranks, one epoch of the Trainer phase's split
    t = time.monotonic()
    data_dir = os.path.join(REPO, "build", "chip_smoke_trainer", "data")
    out_dir = os.path.join(root, "cli")
    argv = ["--data_dir", data_dir, "--synthetic_mano", "--output", out_dir,
            "--batch_size", str(TRAIN_BATCH), "--epochs", "1", "--dtype",
            "bfloat16", "--bone_splat", "--fused_bottleneck",
            "--fused_l2_bands", "4", "--device_pipeline", "--devices",
            str(world), "--backend", backend]
    outs = [os.path.join(root, f"cli{r}.json") for r in range(world)]
    _spawn_ranks(_dp_cli_rank, world, lambda r: (argv, outs[r]))
    cli = []
    for path in outs:
        with open(path) as f:
            cli.append(json.load(f))
    summary = cli[0]["summaries"][-1]
    # one rank on the same weights, at the ranks' batch of 32
    ckpt_dir = os.path.join(out_dir, "checkpoint")
    cfg = Config(model=dp_config(), data=DataConfig(
        data_dir=data_dir, img_size=256, num_workers=4,
        device_pipeline=True), train=TrainConfig(
            batch_size=TRAIN_BATCH // world, total_epochs=1,
            print_every=1, draw_every=0, eval_every_epochs=1,
            output_dir=os.path.join(root, "one"), continue_train=True,
            checkpoint=ckpt_dir))
    one = Trainer(cfg, mano_l, mano_r, device="cuda")
    one.make_data()
    one.make_model(init_state_dict=ckpt.load_checkpoint_weights(ckpt_dir))
    on_same = one.evaluate()
    del one
    torch.cuda.empty_cache()
    s_err = max(abs(summary[k] - v) / abs(v) for k, v in on_same.items())
    launches_cli = tuple(sum(r["launches"][i] for r in cli)
                         for i in range(len(KERNELS)))
    say(f"dp train app: {world} {backend} ranks, one epoch of "
        f"{TRAINER_TRAIN // TRAIN_BATCH} steps of {TRAIN_BATCH} with the "
        f"device pipeline: launches per rank per step of {KERNELS} "
        f"{[[e['launches'] for e in r['train']] for r in cli]}, per eval "
        f"batch {[[e['launches'] for e in r['eval']] for r in cli]} (rank 0's"
        f" first is the overlay dump's forward); step ms by rank "
        f"{[[round(e['ms'], 1) for e in r['train']] for r in cli]}; eval "
        f"batch ms {[[round(e['ms'], 1) for e in r['eval']] for r in cli]};"
        f" in-loop joint_mean_all_mm {summary['joint_mean_all_mm']:.4f}, "
        f"one rank on the same weights at batch {TRAIN_BATCH // world} "
        f"{on_same['joint_mean_all_mm']:.4f}, worst summary term "
        f"{s_err:.3g} relative (bound {DP_SUMMARY_RTOL}); "
        f"{time.monotonic() - t:.1f} s")
    for r in cli:
        if any(tuple(e["launches"]) != EXPECTED["T"] for e in r["train"]):
            raise RuntimeError("dp train app: a step's launches")
        if not r["eval"] or any(tuple(e["launches"]) != EXPECTED_TRAINER_EVAL
                                for e in r["eval"]):
            raise RuntimeError("dp train app: an eval batch's launches")
    if s_err > DP_SUMMARY_RTOL or not np.isfinite(cli[0]["best"]):
        raise RuntimeError("dp train app: the in-loop summary differs from "
                           "one rank's on the same weights")
    result["train_app"] = {
        "launches_per_step": [[e["launches"] for e in r["train"]]
                              for r in cli],
        "launches_per_eval_batch": [[e["launches"] for e in r["eval"]]
                                    for r in cli],
        "step_ms": [[e["ms"] for e in r["train"]] for r in cli],
        "eval_batch_ms": [[e["ms"] for e in r["eval"]] for r in cli],
        "summary": summary, "one_rank_summary": on_same,
        "summary_rel_err": s_err, "seconds": time.monotonic() - t}
    launches_eval, result["eval_k3"] = dp_eval_k3(mods, world, backend,
                                                  data_dir, root)
    shutil.rmtree(root, ignore_errors=True)
    launches = tuple(sum(x) for x in zip(launches_a, launches_b, launches_cli,
                                         launches_eval))
    return launches, result


def dp_eval_k3(mods, world: int, backend: str, data_dir: str, root: str):
    """``apps/eval.py --devices N --quant_static --quant_fused`` (C's int8
    flags, bf16, random weights) over the Trainer phase's test split, its
    ranks over ``backend``, against one rank: K3's launches counted in each
    rank, and the SUMMARY against ``--devices 1`` at the same global
    batch."""
    from dir_tpu_torch.apps import eval as eval_app

    t = time.monotonic()
    args = ["--model", "random", "--data_path", data_dir, "--synthetic_mano",
            "--bs", str(TRAIN_BATCH), "--dtype", "bfloat16",
            "--quant_backbone", "--quant_decoder", "--quant_aux",
            "--quant_static", "--quant_fused", "--quant_fused_l2_bands", "4",
            "--resume_every", "0"]
    outs = [os.path.join(root, f"eval{r}.json") for r in range(world)]
    _spawn_ranks(_dp_eval_rank, world, lambda r: (
        args + ["--out", os.path.join(root, "eval_ranks"), "--devices",
                str(world), "--backend", backend], outs[r]))
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    summary = ranks[0]["summary"]
    reset_counts(mods)
    one = eval_app.main(args + ["--out", os.path.join(root, "eval_one")])
    one_launches = kernel_counts(mods)
    err = max(abs(summary[k] - v) / abs(v) for k, v in one.items())
    by_rank = [tuple(r["launches"]) for r in ranks]
    k3 = KERNELS.index("K3")
    say(f"dp eval with K3: {world} {backend} ranks, --quant_static "
        f"--quant_fused at global batch {TRAIN_BATCH} over the "
        f"{TRAINER_TEST} test samples: launches of {KERNELS} by rank "
        f"{by_rank} (one rank {one_launches}); joint_mean_all_mm "
        f"{summary['joint_mean_all_mm']:.4f}, one rank "
        f"{one['joint_mean_all_mm']:.4f}, worst summary term {err:.3g} "
        f"relative (bound {DP_SUMMARY_RTOL}); "
        f"{time.monotonic() - t:.1f} s")
    if any(n != one_launches or not n[k3]
           or sum(n) != n[k3] for n in by_rank):
        raise RuntimeError("dp eval with K3: a rank's launches")
    if err > DP_SUMMARY_RTOL:
        raise RuntimeError("dp eval with K3: the summary differs from one "
                           "rank's")
    return (tuple(sum(r[i] for r in by_rank) for i in range(len(KERNELS))),
            {"launches_by_rank": by_rank, "one_rank_launches": one_launches,
             "summary": summary, "one_rank_summary": one,
             "summary_rel_err": err, "seconds": time.monotonic() - t})


def cuda_ops(fn) -> int:
    """Device operations (kernels, copies, fills) that one call of ``fn``
    ran, from a ``torch.profiler`` trace of the card; 0 where the trace saw
    none."""
    from torch.profiler import ProfilerActivity, profile

    from dir_tpu_torch.utils.profiling import device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(device_events(prof))


def post(url: str, img: np.ndarray) -> dict:
    """One ``POST /infer`` with an .npy body; the .npz response's arrays."""
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, img)
    with urllib.request.urlopen(url + "/infer", buf.getvalue(),
                                timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def stats(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        return json.loads(r.read())


def response_err(resp: dict, out: dict, rows=slice(None)) -> tuple:
    """Max abs difference of an HTTP response from the live model's outputs
    (rows ``rows`` of them): the final stage's joints, meshes and offset in
    mm, and the seg and dense maps."""
    fin = out["stages"][-1]
    keys = ("mesh_xyz_left", "mesh_xyz_right", "joint_xyz_left",
            "joint_xyz_right", "offset")
    mm = max(float(np.abs(resp[k] - fin[f"pd_{k}"][rows].float().cpu()
                          .numpy()).max()) for k in keys) * 1e3
    maps = max(float(np.abs(resp[k] - out[k][rows].float().cpu().numpy())
                     .max()) for k in ("seg", "dense"))
    return mm, maps


def as_response(out: dict) -> dict:
    """A live model's outputs as ``/infer --full`` returns them."""
    fin = out["stages"][-1]
    keys = ("mesh_xyz_left", "mesh_xyz_right", "joint_xyz_left",
            "joint_xyz_right", "offset")
    resp = {k: fin[f"pd_{k}"] for k in keys}
    resp.update(seg=out["seg"], dense=out["dense"])
    return {k: v.float().cpu().numpy() for k, v in resp.items()}


def spread(times) -> dict:
    """Count, min, median, p90 and max of a list of milliseconds."""
    t = sorted(times)
    return {"n": len(t), "min": t[0], "median": t[len(t) // 2],
            "p90": t[min(len(t) - 1, (9 * len(t)) // 10)], "max": t[-1]}


def time_calls(fn, reps: int = IN_PROCESS_REPS) -> list:
    """Host-clock milliseconds of ``reps`` calls of ``fn``, each waited for
    (``fn`` brings its result to the host)."""
    times = []
    with torch.inference_mode():
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def http_session(mods, path: str, name: str, live_infer, images: dict,
                 microbatch: int, window_ms: float, buckets) -> dict:
    """Serve the artifact at ``path`` through ``apps/serve_http.py``'s
    server on a free local port, with its micro-batcher; POST batch 1, batch
    8 and 8 concurrent batch-1 requests (repeated for latency); hold every
    response against ``live_infer`` on the same images (on the ops the
    artifact holds: :func:`traced_ops`) and every dispatch's kernel
    launches against configuration ``name``'s. Returns the record, with the
    launches of the whole session."""
    import threading

    from dir_tpu_torch.apps import serve_http

    t = time.monotonic()
    srv = serve_http.make_server(path, "127.0.0.1", 0, full=True,
                                 max_batch=microbatch, window_ms=window_ms,
                                 buckets=buckets)
    load_s = time.monotonic() - t
    t = time.monotonic()
    serve_http.warmup(srv.infer, buckets or (1, 8))
    warm_s = time.monotonic() - t
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    record = {"load_s": load_s, "warmup_s": warm_s, "err_mm": 0.0,
              "err_maps": 0.0, "latency_ms": {}, "per_dispatch": {}}
    try:
        with torch.inference_mode(), traced_ops():
            ref = {b: live_infer(images[b]) for b in (1, 8)}
            # a single-flight server answers each of a burst's requests
            # alone: its reference is the live model on the image alone
            alone = [live_infer(images[8][i:i + 1]) for i in range(8)]
            torch.cuda.synchronize()
        # bf16 results depend on the batch size a forward runs at (cuDNN's
        # algorithms and tiles): the live model's own spread, and how far
        # apart two images' outputs lie
        record["live_batch_spread"] = max(
            response_err(as_response(alone[i]), ref[8], slice(i, i + 1))
            for i in range(8))
        record["live_image_gap"] = min(
            response_err(as_response(alone[i]), ref[8], slice(j, j + 1))
            for i in range(8) for j in range(8) if i != j)
        say(f"artifact {name}: the live model on an image alone against "
            f"its row of batch 8: max {record['live_batch_spread']} (mm, "
            "seg/dense); two different images' outputs: at least "
            f"{record['live_image_gap']}")
        if record["live_image_gap"][0] < 100 * HTTP_TOL_MM:
            raise RuntimeError("two images' outputs lie too close for the "
                               "response check to tell them apart")

        def check(resp, *refs):
            """The response against each (outputs, rows) reference; the
            closest one counts."""
            mm, maps = min(response_err(resp, out, rows) for out, rows in refs)
            record["err_mm"] = max(record["err_mm"], mm)
            record["err_maps"] = max(record["err_maps"], maps)
            by_shape[shape] = tuple(max(a, b) for a, b in zip(
                by_shape.get(shape, (0.0, 0.0)), (mm, maps)))

        def burst():
            """8 concurrent batch-1 requests, image i of batch 8 each."""
            got, lat = [None] * 8, [0.0] * 8

            def one(i):
                t0 = time.perf_counter()
                got[i] = post(url, images[8][i:i + 1])
                lat[i] = (time.perf_counter() - t0) * 1e3

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            # a request the micro-batcher dispatched alone ran at batch 1,
            # one in a group at its bucket, 8: its reference is the live
            # model at that batch size (in a batch of 8 a row's result
            # does not depend on its neighbours or its position)
            for i in range(8):
                if microbatch:
                    check(got[i], (ref[8], slice(i, i + 1)),
                          (alone[i], slice(None)))
                else:
                    check(got[i], (alone[i], slice(None)))
            return lat

        by_shape = {}
        reset_counts(mods)
        session_start = kernel_counts(mods)
        shapes = (("batch 1", lambda: [post(url, images[1])]),
                  ("batch 8", lambda: [post(url, images[8])]),
                  ("8 concurrent batch 1", burst))
        for shape, run in shapes:
            before_stats = stats(url)
            before = kernel_counts(mods)
            times = []
            reps = (-(-HTTP_REQUESTS // 8) if shape == "8 concurrent batch 1"
                    else HTTP_REQUESTS)
            for _ in range(reps):
                t0 = time.perf_counter()
                out = run()
                if shape == "8 concurrent batch 1":
                    times += out
                else:
                    times.append((time.perf_counter() - t0) * 1e3)
                    check(out[0], (ref[1 if shape == "batch 1" else 8],
                                   slice(None)))
            after = stats(url)
            dispatches = after["dispatches"] - before_stats["dispatches"]
            images_n = after["images"] - before_stats["images"]
            launched = tuple(a - b for a, b in zip(kernel_counts(mods),
                                                   before))
            per = tuple(n / dispatches for n in launched)
            lat = spread(times)
            record["latency_ms"][shape] = lat
            record["per_dispatch"][shape] = {
                "launches": per, "dispatches": dispatches,
                "avg_batch": images_n / dispatches}
            say(f"artifact {name} over HTTP, {shape}: ms per request "
                f"{lat}; {dispatches} dispatches, avg_batch "
                f"{images_n / dispatches:.2f}; launches per dispatch of "
                f"{KERNELS} {per}")
            if per != tuple(float(n) for n in EXPECTED[name]):
                raise RuntimeError(
                    f"artifact {name}, {shape}: {KERNELS} ran {per} times "
                    f"a dispatch, expected {EXPECTED[name]}")
        record["launches"] = tuple(a - b for a, b in zip(kernel_counts(mods),
                                                         session_start))
        record["stats"] = stats(url)
        record["err_by_shape"] = by_shape
        # the live model against itself across the session: cuDNN may
        # choose another algorithm for a shape as the free memory changes
        with torch.inference_mode(), traced_ops():
            record["live_drift"] = {
                b: response_err(as_response(live_infer(images[b])), ref[b])
                for b in (1, 8)}
        # the same requests without HTTP: the artifact and the live model
        # called in this process, the response's tensors brought to the
        # host as the server brings them
        record["in_process_ms"] = {b: {
            "artifact": spread(time_calls(
                lambda: as_response(srv.infer(images[b])))),
            "live": spread(time_calls(
                lambda: as_response(live_infer(images[b]))))}
            for b in (1, 8)}
        say(f"artifact {name}: ms per call in process, batch 1 and 8 "
            f"{record['in_process_ms']}")
        say(f"artifact {name} over HTTP: max abs err by request shape (mm, "
            f"seg/dense) {by_shape}; the live model against itself at the "
            f"end of the session {record['live_drift']}")
        # CUDA operations a request runs, artifact against live model (C's
        # unfused int8 convs fold and quantize their weights on every call
        # in both)
        record["cuda_ops_per_request"] = {b: {
            "artifact": cuda_ops(lambda: srv.infer(images[b])),
            "live": cuda_ops(lambda: live_infer(images[b]))} for b in (1, 8)}
        say(f"artifact {name}: CUDA operations per request (torch.profiler; "
            f"0 = the trace saw none) {record['cuda_ops_per_request']}")
        say(f"artifact {name} over HTTP: max abs err against the live model "
            f"{record['err_mm']:.6f} mm (tolerance {HTTP_TOL_MM} mm), seg "
            f"and dense {record['err_maps']:.6f} (tolerance {HTTP_TOL_MAP}); "
            f"/stats {record['stats']}")
        if record["err_mm"] > HTTP_TOL_MM or record["err_maps"] > HTTP_TOL_MAP:
            raise RuntimeError(f"artifact {name}: a response is off the live "
                               "model")
    finally:
        srv.shutdown()
        srv.server_close()
        if srv.batcher is not None:
            srv.batcher.stop()
        thread.join(timeout=30)
    return record


def load_in_subprocess(root: str, path: str, live, images):
    """Start a fresh process that loads configuration B's artifact with no
    model code and answers one batch-1 request, against the live model's
    answer on the ops the artifact holds (:func:`traced_ops`); it prints
    one JSON line."""
    with torch.inference_mode(), traced_ops():
        want = live["infers"]["B"](images[1])["stages"][-1][
            "pd_mesh_xyz_left"].float().cpu().numpy()
    np.save(os.path.join(root, "img1.npy"), images[1])
    np.save(os.path.join(root, "want1.npy"), want)
    code = "\n".join([
        "import json, sys, time",
        "import numpy as np, torch",
        f"sys.path.insert(0, {REPO!r})",
        "from dir_tpu_torch import serve",
        "t = time.monotonic()",
        f"fn = serve.load({path!r})",
        "load_s = time.monotonic() - t",
        f"img = np.load({os.path.join(root, 'img1.npy')!r})",
        "got = fn(img)['stages'][-1]['pd_mesh_xyz_left'].float().cpu()",
        f"want = np.load({os.path.join(root, 'want1.npy')!r})",
        "print(json.dumps({'load_s': load_s, 'err_mm': float(np.abs("
        "got.numpy() - want).max()) * 1e3, 'finite': bool(torch.isfinite("
        "got).all()), 'models': sorted(k for k in sys.modules if "
        "k.startswith('dir_tpu_torch.models')), 'jax': 'jax' in "
        "sys.modules}))"])
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def artifact_phase(mods, live):
    """Configurations B and C exported as serving artifacts (symbolic
    batch, on the card) and served: the graphs' kernel ops, a subprocess
    that loads B with no model code, B over HTTP with the micro-batcher, C
    over HTTP, the CUDA operations per request of artifact and live model,
    and the infer app."""
    from dir_tpu_torch import serve
    from dir_tpu_torch.apps import infer as infer_app

    root = os.path.join(REPO, "build", "chip_smoke_artifacts")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    mano_l, mano_r = live["mano"]
    images = live["images"]
    result, paths = {}, {}
    sub = None
    for name in "BC":
        t = time.monotonic()
        program = serve.export_program(live["models"][name], mano_l, mano_r)
        torch.cuda.synchronize()
        export_s = time.monotonic() - t
        counts = serve.op_counts(program)
        t = time.monotonic()
        blob = serve.serialize(program)
        paths[name] = os.path.join(root, f"{name}.pt2")
        serve.save(paths[name], blob)
        result[name] = {"export_s": export_s,
                        "save_s": time.monotonic() - t, "bytes": len(blob),
                        "ops": counts, "graph_nodes": len(program.graph.nodes)}
        say(f"artifact {name}: exported in {export_s:.1f} s (symbolic batch), "
            f"serialized in {result[name]['save_s']:.1f} s, {len(blob)} "
            f"bytes, {len(program.graph.nodes)} graph nodes; kernel ops "
            f"named: {counts}")
        if counts != ARTIFACT_OPS[name]:
            raise RuntimeError(f"artifact {name} names {counts}, expected "
                               f"{ARTIFACT_OPS[name]}")
        del program, blob
        if sub is None:       # loads B while C is exported
            sub = load_in_subprocess(root, paths["B"], live, images)
    try:
        out_s, err_s = sub.communicate(timeout=600)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.wait()
    if sub.returncode != 0:
        raise RuntimeError(f"the artifact subprocess failed: {err_s[-4000:]}")
    loaded = json.loads(out_s.strip().splitlines()[-1])
    say(f"artifact B in a fresh process: loaded in {loaded['load_s']:.1f} s, "
        f"batch 1 against the live model {loaded['err_mm']:.6f} mm, model "
        f"modules imported {loaded['models']}, jax imported "
        f"{loaded['jax']}")
    if (loaded["models"] or loaded["jax"] or not loaded["finite"]
            or loaded["err_mm"] > HTTP_TOL_MM):
        raise RuntimeError(f"the artifact subprocess: {loaded}")
    result["subprocess"] = loaded

    for name, microbatch, buckets in (("B", 8, (1, 8)), ("C", 0, ())):
        result[name]["http"] = http_session(
            mods, paths[name], name, live["infers"][name], images,
            microbatch, HTTP_WINDOW_MS, buckets)
        result[f"launches {name}"] = result[name]["http"].pop("launches")

    for path in paths.values():
        os.remove(path)

    # the infer app, full depth at fp32, on one seeded image
    out_dir = os.path.join(root, "infer")
    img_path = os.path.join(root, "crop.png")
    import cv2
    cv2.imwrite(img_path, (np.random.RandomState(2).rand(256, 256, 3) * 255)
                .astype(np.uint8))
    t = time.monotonic()
    final = infer_app.main(["--image", img_path, "--model", "random",
                            "--synthetic_mano", "--out", out_dir])
    missing = [f for f in infer_app.OUTPUTS
               if not os.path.getsize(os.path.join(out_dir, f))]
    if missing or not all(np.isfinite(v).all() for v in final.values()):
        raise RuntimeError(f"the infer app: empty {missing} or non-finite")
    result["infer_app_s"] = time.monotonic() - t
    say(f"infer app: {sorted(os.listdir(out_dir))} in "
        f"{result['infer_app_s']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return result


def train_cli_phase() -> dict:
    """``apps/train.py`` on the Trainer phase's synthetic split: one epoch
    of 2 steps of configuration T's flags, with its in-loop eval."""
    from dir_tpu_torch.apps import train as train_app

    fb, q8, st, bs = (sys.modules[f"dir_tpu_torch.ops.{m}"] for m in (
        "fused_bottleneck", "fused_bottleneck_int8", "fused_stem_bottleneck",
        "bone_splat"))
    root = os.path.join(REPO, "build", "chip_smoke_trainer")
    reset_counts((fb, q8, st, bs))
    t = time.monotonic()
    best = train_app.main([
        "--data_dir", os.path.join(root, "data"), "--synthetic_mano",
        "--output", os.path.join(root, "cli"), "--batch_size",
        str(TRAIN_BATCH), "--epochs", "1", "--dtype", "bfloat16",
        "--bone_splat", "--fused_bottleneck", "--fused_l2_bands", "4"])
    torch.cuda.synchronize()
    launches = kernel_counts((fb, q8, st, bs))
    seconds = time.monotonic() - t
    shutil.rmtree(os.path.join(root, "cli"), ignore_errors=True)
    # the steps, the one in-loop eval batch and the overlay dump's eval
    # forward at step 0
    steps = TRAINER_TRAIN // TRAIN_BATCH
    want = tuple(steps * t + 2 * e for t, e in zip(EXPECTED["T"],
                                                   EXPECTED_TRAINER_EVAL))
    say(f"train CLI: one epoch of {steps} steps and its eval in "
        f"{seconds:.1f} s, best MPJPE {best:.4f} mm; launches of {KERNELS} "
        f"{launches} (expected {want})")
    if launches != want or not np.isfinite(best):
        raise RuntimeError("the train CLI did not run as configured")
    return {"seconds": seconds, "best_mm": best, "launches": launches}


def convergence_phase() -> dict:
    """``python -m dir_tpu_torch.apps.convergence`` at its defaults (full
    width, 320 steps at batch 64, bf16) in its own process on the card:
    its curve, finite, and the last loss at most CONVERGENCE_RATIO of the
    first."""
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "dir_tpu_torch.apps.convergence"], cwd=REPO,
        capture_output=True, text=True, timeout=CONVERGENCE_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        say(f"convergence: {line}")
    if proc.returncode:
        raise RuntimeError(f"convergence exited with {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    summary = json.loads(lines[-1])
    curve = [float(line.split("loss=")[1].split()[0]) for line in lines
             if line.startswith("step=")]
    ratio = summary["final_loss"] / summary["first_loss"]
    say(f"convergence: {summary['steps']} steps, loss "
        f"{summary['first_loss']:.6f} -> {summary['final_loss']:.6f} "
        f"(ratio {ratio:.4f}, bound {CONVERGENCE_RATIO}), ms per step "
        f"{summary['ms_per_step_median']:.3f}; {time.monotonic() - t:.1f} s")
    if not (np.isfinite(curve).all() and np.isfinite(ratio)
            and ratio <= CONVERGENCE_RATIO):
        raise RuntimeError("convergence: a loss is not finite or the loss "
                           "did not fall enough")
    return dict(summary, curve=curve, seconds=time.monotonic() - t)


def f1_phase(mods):
    """An fp32 trunk under the fused flags serves on the card: the guards
    send the blocks the kernels would take (bf16 only) to the unfused fp32
    block (``fused_bottleneck_eval=True, fused_l2_bands=4``) and to the
    unfused int8 route (C's flags), and the model agrees with the same
    weights without the fused flags."""
    from dir_tpu_torch import weights
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.models.resnet import Bottleneck
    from dir_tpu_torch.serve import (CONFIG_C, calibrate_static_scales,
                                     flagship_mano, make_infer, random_init_)

    layers = (3, 1, 1, 1)
    mano_l, mano_r = (m.to("cuda") for m in flagship_mano())
    img = np.random.RandomState(1).randn(2, 256, 256, 3).astype(np.float32)
    errs = {}
    for key, name, flags in (
            ("bf16_fused", "the bf16 kernels'",
             dict(fused_bottleneck_eval=True, fused_l2_bands=4)),
            ("C", "C's", CONFIG_C)):
        model = random_init_(DIR(ModelConfig(backbone_layers=layers,
                                             **flags)), seed=0).cuda().eval()
        plain = DIR(ModelConfig(backbone_layers=layers, **dict(
            flags, fused_bottleneck_eval=False, quant_fused=False))).cuda()
        plain.load_state_dict(model.state_dict(), strict=True)
        if flags.get("quant_static"):
            calibrate_static_scales(model, img, mano_l, mano_r)
            weights.load_amax(plain, weights.quant_stats_to_amax(
                weights.amax_to_quant_stats(model, layers), layers))
        reset_counts(mods)
        before = Bottleneck.fp32_unfused_runs
        out = make_infer(model, mano_l, mano_r)(img)
        torch.cuda.synchronize()
        routed = Bottleneck.fp32_unfused_runs - before
        if any(kernel_counts(mods)) or routed != 2:
            raise RuntimeError(f"fp32 with {name} flags: launches "
                               f"{kernel_counts(mods)}, {routed} blocks "
                               "routed unfused (expected 2)")
        check_outputs(out, 2)
        ref = make_infer(plain.eval(), mano_l, mano_r)(img)
        pairs = [(so[k], sr[k]) for so, sr in zip(out["stages"],
                                                  ref["stages"]) for k in sr]
        pairs += [(out[k], ref[k]) for k in ("seg", "dense")]
        err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in pairs)
        say(f"fp32 trunk with {name} fused flags, (3,1,1,1): served, "
            f"{routed} blocks routed unfused, no kernel launched; max err "
            f"against the model without the fused flags {err:.3g} of each "
            "output's max")
        if err > F1_RTOL:
            raise RuntimeError(f"fp32 with {name} flags disagrees")
        errs[key] = err
        del model, plain
    return errs


def hold_components(text: str) -> dict:
    """The component tool's output: the JAX tool's nine entries by name and
    in order, each line after its ``component`` line, K5 launched once by
    the traced call of each ``_pallas`` entry and by no other. Returns each
    entry's numbers."""
    from dir_tpu_torch.tools.bench_components import NAMES

    lines = [ln for ln in text.splitlines()
             if COMPONENT_LINE.match(ln) or COMPONENT_JAX_LINE.match(ln)]
    if len(lines) != 2 * len(NAMES):
        raise RuntimeError(f"bench_components printed {len(lines)} entry "
                           f"lines, not {2 * len(NAMES)}")
    records = {}
    for name, comp, line in zip(NAMES, lines[0::2], lines[1::2]):
        c, j = COMPONENT_LINE.match(comp), COMPONENT_JAX_LINE.match(line)
        if not (c and j and c.group(1) == j.group(1) == name):
            raise RuntimeError(f"bench_components: expected {name}, read "
                               f"{comp!r} then {line!r}")
        k5 = int(c.group(5))
        if k5 != int(name.endswith("_pallas")):
            raise RuntimeError(f"bench_components: {name} launched K5 {k5} "
                               "times")
        records[name] = {"ms": float(j.group(2)),
                         "img_per_s": int(j.group(3)),
                         "device_ms": float(c.group(2)),
                         "launches": int(c.group(3)),
                         "busy_pct": float(c.group(4)), "k5": k5}
    return records


def components_splat_check(bs) -> float:
    """The component tool's splats at its batch-64 draws: K5 against its
    plain version at both stage sizes (comparison launches, not counted)."""
    from dir_tpu_torch.tools import bench_components as tool

    data = tool.draws(tool.BATCH)
    uv = torch.from_numpy(data["uv"]).cuda()
    feat = torch.from_numpy(data["feat"]).to("cuda", torch.bfloat16)
    return max(compare_splat(bs, uv, feat, size, distance,
                             f"bench_components (B {tool.BATCH}, S {size}, "
                             f"distance {distance})")
               for size, distance in tool.SPLATS)


def bench_phase(mods):
    """``python -m dir_tpu_torch.bench`` at cut repetitions in its own
    process, its last line held to bench.py's keys; K1's launches counted
    here over one unrolled eval call of the bench's flagship (2 a forward);
    then each tool of ``dir_tpu_torch/tools`` and ``profile_serve`` at the
    bench's batch once, at cut repetitions, all at once, each in its own
    process; the component tool's lines held and its splats checked. Prints
    every line; returns the counts, K5's launches in the component tool's
    traced calls and the bench's record."""
    from dir_tpu_torch import bench

    t = time.monotonic()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "dir_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT,
                          env=dict(os.environ, **BENCH_ENV))
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        say(f"bench: {line}")
    if proc.returncode or not lines:
        raise RuntimeError(f"the bench exited with {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    record = json.loads(lines[-1])
    bad = [k for k in BENCH_KEYS
           if not (np.isfinite(record.get(k, np.nan)) and record[k] > 0)]
    if bad or "error" in record or "serving_int8_static_error" in record \
            or "H100" not in record.get("device", ""):
        raise RuntimeError(f"the bench's line lacks or fails {bad}: {record}")
    bench_seconds = time.monotonic() - t

    model, _, mano_l, mano_r = bench.conditioned_flagship(
        torch.device("cuda"), **bench.eval_flags(0, False, True))
    img = torch.from_numpy(np.random.RandomState(0).randn(
        bench.BATCH, 256, 256, 3).astype(np.float32)).cuda()
    images = torch.stack([img] * BENCH_UNROLL)
    call = bench.eval_call(model, mano_l, mano_r, BENCH_UNROLL)
    call(images)
    torch.cuda.synchronize()
    reset_counts(mods)
    outs = call(images)
    torch.cuda.synchronize()
    launches = kernel_counts(mods)
    want = tuple(BENCH_UNROLL * n for n in EXPECTED["A"])
    say(f"bench: one eval call of {BENCH_UNROLL} forwards at batch "
        f"{bench.BATCH} launched {KERNELS} {launches} (expected {want})")
    if launches != want:
        raise RuntimeError("the bench's eval call did not launch K1 twice a "
                           "forward")
    bench.check_finite([x for triple in outs for x in triple], "bench eval")
    del model, img, images, outs
    torch.cuda.empty_cache()

    t_tools = time.monotonic()
    logs = os.path.join(REPO, "build", "chip_smoke_tools")
    shutil.rmtree(logs, ignore_errors=True)
    os.makedirs(logs)
    running = []
    try:
        for name, argv, env in TOOLS:
            out = open(os.path.join(logs, f"{name}.out"), "w")
            err = open(os.path.join(logs, f"{name}.err"), "w")
            running.append((name, out, err, subprocess.Popen(
                [sys.executable, *argv], cwd=REPO, stdout=out, stderr=err,
                env=dict(os.environ, **env))))
        deadline = time.monotonic() + TOOLS_TIMEOUT
        failed = []
        for name, out, err, p in running:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            out.close()
            err.close()
            with open(out.name) as f:
                text = f.read()
            for line in text.strip().splitlines():
                say(f"{name}: {line}")
            if name == "bench_components" and not rc:
                components = hold_components(text)
            if rc:
                with open(err.name) as f:
                    say(f"{name}: exited with {rc}: {f.read()[-3000:]}")
                failed.append(name)
    finally:
        for _, _, _, p in running:
            if p.poll() is None:
                p.kill()
                p.wait()
    tools_seconds = time.monotonic() - t_tools
    shutil.rmtree(logs, ignore_errors=True)
    say(f"bench phase: the bench {bench_seconds:.1f} s, the tools together "
        f"{tools_seconds:.1f} s, {time.monotonic() - t:.1f} s in all")
    if failed:
        raise RuntimeError(f"tools failed: {failed}")
    k5_components = sum(r["k5"] for r in components.values())
    say(f"bench_components: nine entries in the JAX tool's order, K5 "
        f"launched {k5_components} times in their traced calls (once by "
        "each _pallas entry)")
    splat_err = components_splat_check(mods[3])
    return launches, k5_components, {
        "line": record, "seconds": time.monotonic() - t,
        "bench_seconds": bench_seconds, "tools_seconds": tools_seconds,
        "components": components, "components_k5_max_abs_err": splat_err}


def multi_card(mods, devices: int) -> int:
    """``--devices N``: the data-parallel phase alone, its ranks over NCCL,
    one a card, on the Trainer's synthetic split; prints the parallel line
    and the one-line result."""
    from dir_tpu_torch.serve import flagship_mano

    root = os.path.join(REPO, "build", "chip_smoke_trainer")
    shutil.rmtree(root, ignore_errors=True)
    write_split(os.path.join(root, "data"), *flagship_mano())
    launches, parallel = dp_phase(mods, devices, "nccl")
    shutil.rmtree(root, ignore_errors=True)
    parallel["launches"] = launches
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="above 1: only the data-parallel phase (6b), its "
                         "ranks over NCCL, one a card")
    devices = ap.parse_args(argv).devices
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on the card")
    if devices > torch.cuda.device_count():
        raise SystemExit(f"chip_smoke: --devices {devices} on "
                         f"{torch.cuda.device_count()} card(s)")
    sys.path.insert(0, REPO)
    from dir_tpu_torch.ops import bone_splat as bs
    from dir_tpu_torch.ops import conv_epilogue as ce
    from dir_tpu_torch.ops import cuda_build
    from dir_tpu_torch.ops import fused_bottleneck as fb
    from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
    from dir_tpu_torch.ops import fused_stem_bottleneck as st
    from dir_tpu_torch.ops import quant

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t_build = time.monotonic()
    reports = cuda_build.build_many([(fb.NAME, fb.NVCC_EXTRA_FLAGS),
                                     (q8.NAME, q8.NVCC_EXTRA_FLAGS),
                                     (st.NAME, st.NVCC_EXTRA_FLAGS),
                                     (bs.NAME, bs.NVCC_EXTRA_FLAGS)])
    for name, log in reports.items():
        for line in log.splitlines():
            if "Compiling entry" in line:
                say(f"ptxas {name}: " + line.split("'")[1])
            elif "registers" in line or "spill" in line or "smem" in line:
                say(f"ptxas {name}:   {line.strip()}")
    say("K1, K2 (fused_bottleneck), K3 (fused_bottleneck_int8), K4 "
        "(fused_stem_bottleneck) and K5 (bone_splat) built in "
        f"{time.monotonic() - t_build:.1f} s")

    mods = (fb, q8, st, bs)
    if devices > 1:
        return multi_card(mods, devices)
    phases = {"build": time.monotonic() - t_build}

    def timed(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        phases[name] = time.monotonic() - t
        return out

    k1 = timed("K1", bottleneck_phase, fb, K1_SHAPE, K1_MID, 0,
               ("identity", "projection"))
    k2 = timed("K2", bottleneck_phase, fb, K2_SHAPE, K2_MID, K2_BANDS,
               ("identity",))
    k3 = timed("K3", int8_phase, q8, quant)
    k4 = timed("K4", stem_phase, st)
    k5 = timed("K5", splat_phase, bs)
    epilogue = timed("epilogue", epilogue_phase, ce)
    launches = {}
    launches["reference"], reference = timed("reference", reference_phase,
                                             mods)
    served, epilogue_launches, served_err, worst_mm, latency, metrics, live = (
        timed("serve", serve_phase, mods))
    launches.update(served)
    artifact = timed("artifact", artifact_phase, mods, live)
    for name in "BC":
        launches[f"artifact {name}"] = artifact.pop(f"launches {name}")
    del live
    torch.cuda.empty_cache()
    launches["T"], train = timed("train", train_phase, mods)
    reset_counts(mods)
    train["f2"] = timed("F2", f2_phase, mods)
    launches["F2"] = kernel_counts(mods)
    torch.cuda.empty_cache()
    train["convergence"] = timed("convergence", convergence_phase)
    launches["trainer"], fed_err, train["trainer"] = timed(
        "trainer", trainer_phase, mods)
    artifact["train_cli"] = timed("train_cli", train_cli_phase)
    launches["dp"], parallel = timed("dp", dp_phase, mods)
    shutil.rmtree(os.path.join(REPO, "build", "chip_smoke_trainer"),
                  ignore_errors=True)
    for key, err in fed_err.items():
        served_err[key] = max(served_err[key], err)
    f1 = timed("F1", f1_phase, mods)
    launches["bench"], k5_components, bench_run = timed("bench", bench_phase,
                                                        mods)
    served_err["K5"] = max(served_err["K5"],
                           bench_run["components_k5_max_abs_err"])

    # times and bound at the path's shape (the identity form for K1 and K2,
    # the layer1 shape for K3, the larger stage for K5); the error is the
    # worst of that check and the served and in-loop eval inputs' checks;
    # launches are the main path's, over A's, B's and C's requests, T's
    # train steps and the Trainer's runs; K5's also the component tool's
    # traced calls. K4 is on no path: its entry holds its standalone check
    # and 0 launches.
    runs = ["reference"] + list(CONFIGS) + [
        "artifact B", "artifact C", "T", "F2", "trainer", "dp", "bench"]
    expected = dict(EXPECTED, trainer=EXPECTED_TRAINER_EVAL,
                    reference=tuple(map(max, zip(
                        *EXPECTED_REFERENCE.values()))),
                    bench=EXPECTED["A"],
                    dp=tuple(max(a, b) for a, b in zip(
                        EXPECTED_TRAINER_EVAL, EXPECTED["C"])),
                    F2=EXPECTED["T"],
                    **{f"artifact {n}": EXPECTED[n] for n in "BC"})

    def entry(key, name, source, replaces, at_shape, elsewhere=None,
              **more):
        index = KERNELS.index(key)
        if (any(expected[n][index] for n in runs)
                and not all(launches[n][index] for n in runs
                            if expected[n][index])):
            raise RuntimeError(f"{key} is on the main path and was not "
                               "launched there")
        by_run = {n: launches[n][index] for n in runs}
        by_run.update(elsewhere or {})
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_run.values()),
            "launches_by_configuration": by_run,
            "max_abs_err": max(at_shape["max_abs_err"], served_err[key]),
            "ms": at_shape["ms"], "plain_ms": at_shape["plain_ms"],
            "bound_ms": at_shape["bound_ms"],
            "bound_by": at_shape["bound_by"],
            "library_ms": at_shape["library_ms"],
            "shape": at_shape.get("shape"),
            **{k: at_shape[k] for k in ("wrapper_ms",) if k in at_shape},
            **more}

    k1["identity"]["shape"] = list(K1_SHAPE) + [K1_MID]
    k2["identity"]["shape"] = list(K2_SHAPE) + [K2_MID]
    kernels = {"kernels": [
        entry("K1", "fused_bottleneck",
              "dir_tpu_torch/csrc/fused_bottleneck.cu",
              "dir_tpu/ops/pallas_bottleneck.py:119", k1["identity"],
              projection=k1["projection"]),
        entry("K2", "fused_bottleneck (streamed form)",
              "dir_tpu_torch/csrc/fused_bottleneck.cu",
              "dir_tpu/ops/pallas_bottleneck.py:130", k2["identity"]),
        entry("K3", "fused_bottleneck_int8",
              "dir_tpu_torch/csrc/fused_bottleneck_int8.cu",
              "dir_tpu/ops/pallas_bottleneck.py:316", k3[0], layer2=k3[1]),
        entry("K4", "fused_stem_bottleneck",
              "dir_tpu_torch/csrc/fused_stem_bottleneck.cu",
              "dir_tpu/ops/pallas_bottleneck.py:169", k4),
        entry("K5", "bone_splat", "dir_tpu_torch/csrc/bone_splat.cu",
              "dir_tpu/ops/pallas_bone_splat.py:36", k5[0],
              elsewhere={"bench_components": k5_components}, stage1=k5[1]),
        # port-only: dir_tpu has no kernel here (XLA fuses the eval BN, the
        # add and the ReLU into its convolutions); its launches are A's, B's
        # and C's requests', EXPECTED_EPILOGUE a request
        {"name": "bias_add_relu_kernel", "route": "triton",
         "source": "dir_tpu_torch/ops/conv_epilogue.py", "replaces": None,
         "launches": sum(epilogue_launches.values()),
         "launches_by_configuration": epilogue_launches,
         **{k: v for k, v in epilogue["stem"].items() if k != "z"},
         **{site: epilogue[site] for site, _, _ in EPILOGUE_SHAPES[1:]}},
    ]}
    say(f"serve: worst final-stage err {worst_mm} mm; latency ms {latency}; "
        f"vs fp32 through batch_metrics {metrics}")
    print(json.dumps({"train": train, "fp32_fused_flags_rel_err": f1}),
          flush=True)
    print(json.dumps({"artifact": artifact}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"bench": bench_run}), flush=True)
    phases["total"] = time.monotonic() - T0
    print(json.dumps({"phases": phases}), flush=True)
    print(json.dumps({"reference": reference}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
