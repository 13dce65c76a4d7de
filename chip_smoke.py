"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--reps N]

Runs ``aec_tpu_torch`` (never JAX): builds the eleven CUDA sources in the
checkout (fourteen kernels: the twelve TPU kernels', K8b, K8's backward,
and K9b, the LSTM backward), and the cut variants that ``kernels/lstm_costs.py``
(K9, K10), ``kernels/single_costs.py`` (K6 / K7), ``kernels/fsn_costs.py``
(K11) and ``kernels/lstm_bwd_costs.py`` (K9b) time, all in parallel, and
drives every user-facing path.

- Offline Kalman (phases 4, 5, 7): each kernel against its plain PyTorch
  version at the main path's full shape (batch 256 x 131,072 samples =
  8.2 s at 16 kHz, L=10 / block 256 / K=257, the width-1 LittleNet of
  ``checkpoints/little_net_robust.npz``; K2 is its phases A and C with K8
  between them, and the main path counts all three), K2's mask also against the plain
  version evaluated in fp64 (there and on full-scale noise through four
  untrained nets, beside TF32 products as the lower-precision control);
  ``two_stage_cancel`` on the 8 scenes of ``benchmarks/scenes.py``, graded
  against the plain (CPU) route, K1 on its FFT step; the ``quality="fast"``
  route, which runs the whole pipeline as K4 (also at batch 1 and 3
  against its plain version); K4 must report its FFT hop.
- Streaming serving (phases 8, 9): K3 against its plain version at
  S = 1024 live streams (bench config ``concurrent_streams``), at S = 1
  and 8 with ``normalize`` and ``gain_norm`` (k = 1 and 4, both filters),
  after an in-place change to a weight (the prepared constants must
  follow it), then the 8 scenes streamed hop by hop through K3 against the
  offline result; K3 must report its FFT hop.
- NLMS and single utterances (phases 11-14): K5 (batched NLMS) at the main
  shape, K6 / K7 (single-stream Kalman / NLMS, one utterance on one CTA)
  on one 16 s utterance (bench configs #1 and #2) and a hop-fractional one,
  twice with other inputs; each must report its FFT step; the 8 scenes
  with ``stage1="nlms"`` through the
  batched (K5 + K2), single-stream (K7 + K2) and serving (K3-NLMS) routes,
  and through the single-stream Kalman route (K6 + K2); K3-NLMS against its
  plain version at S = 1024.
- Times (phases 6, 10, 15): kernels, plain versions and the paths, with
  CUDA events, beside the card's name and power limit; K1 and K2 also as a
  batch of one 8.2 s utterance (K2 also 16 s), K1's and K2's bounds on
  their FFT formulations' work beside the dense DFT formulation's; K3 per
  one-hop call at the 8 streamed scenes' shape (where its launch count
  comes from) and at S = 1024, per filter: the call (CUDA events, the card
  idle before it) beside the kernel's device time (``torch.profiler``), so
  the host's share shows; K3's and K4's bounds on their FFT formulation
  (K3's bytes the state round trip); K6 / K7 also per 8.2 s scene, and
  their µs a step whole and with the constraint's or the echo's transforms
  cut out (``kernels/single_costs.py``); K5's and K6 / K7's bounds on the
  FFT formulation beside the dense one, and ptxas's registers and spills
  for their default instantiations.
- Training (phases 16-19): K8 (the GRU scan) against its plain version at
  B = 1 x 1001 frames (H = 32, 64 and 128) and B = 8 and 16 x 501; at the
  batches, K8's ys with and without saving the gates bit for bit, K8b (its
  backward) against its plain version, and the route's gradients against
  the plain route's; the recurrence and the whole forward beside cuDNN's
  ``nn.GRU`` in turns, with the ratios, and at the batches the route's
  forward and its forward and backward (K8 + K8b) beside cuDNN's, and at
  H = 128 K8b beside cuDNN's backward alone with ptxas's registers and
  spills for K8b's plan there; LittleNet's
  GRU gradients at 1 and 16 x 501 through K8 and K8b against the plain
  route; the trainer of a width-1 LittleNet at ``TrainConfig()``: 5 steps
  at batch 16 x 8 s (K8 and K8b once each; the first against the CPU
  route), validation at batch 1 through K8, a checkpoint round trip, 3
  batch-1 steps; the width-4 net on one utterance at a time (K6 + K8)
  against the CPU route.
- K12 (phase 20): the spectra-in batched Kalman entry against K1 and its
  plain version at the main shape.
- Other geometries (phase 21): the 8 scenes at 4 and 16 partitions (block
  256) and at the 320 / 160 / 320 STFT through K1, K5, K6, K7, K12, K2, K4
  and K3 (both filters) against their plain versions, and through
  ``two_stage_cancel``'s batched, fast and single-utterance routes; then
  K1, K12, K5, K6, K7, K4 and K3 (both filters) each at the largest
  partition count its wrapper accepts at blocks 256 and 160, against the
  plain versions, and one partition more, which must be refused for
  shared memory. K1, K12, K5, K6, K7, K2, K3 (both filters) and K4 also at
  block 224, whose FFT has no radix plan: they must report their dense
  steps / routes / transforms / hops there, and their FFT ones at every
  other geometry.
  K4 against the plain composition at each geometry is also read against
  the composition's fp64 evaluation, with TF32 products as the control;
  on the bulk_delay scene at block 160 (three seeds, K4 twice), where
  every fp32 evaluation's mask lies farthest from fp64.
- K8's and K8b's wide path (phase 16, ``csrc/gru_wide.cu``): K8 at B = 1 x
  1001 at H = 129 and 512 and at the DCT-CNN's training batch, 16 x 501 at
  H = 512, against its plain version, its ys with and without saving the
  gates bit for bit, beside cuDNN's ``nn.GRU``; K8b there against its plain
  version and the route's gradients against the plain route's, beside
  cuDNN's forward and backward; both kernels whole and without their dots
  (``kernels/gru_wide_costs.py``).
- DCCRN inference (phases 22-23): K9 (the grouped complex LSTM) at
  ``DccrnConfig()``'s width (I = H = 1024 per part, T = 513) at B = 1 and
  16 (the largest B routed) against its plain version, beside the plain
  scan and cuDNN's ``nn.LSTM``; its time per step, where its weights lie
  (registers, shared memory, L2), the same kernel with its dots cut out
  (``kernels/lstm_costs.py``: the barrier, h's exchange and the cells) and
  ptxas's registers and spills; ``cli/infer``'s DCCRN enhancer (Kalman
  stage 1) on the 8 scenes one by one, kernel route (K1 + K9) against the
  plain route, cuDNN's TF32 off, its call timed with the packed weights
  cold and warm beside K9's device time in it. At DCCRN's training shape
  (16 x 501 frames) K9's ys with and without saving the gates bit for bit,
  K9b (the LSTM backward) against its plain version, the route's gradients
  against the plain route's (no plain loop entered), and the route's
  forward and backward and its backward alone beside cuDNN's ``nn.LSTM``;
  K9b's split there (``kernels/lstm_bwd_costs.py``: µs a step whole and
  without its dots, its staging of dxp, its waits, its cells) beside
  143f1cb's design's.
- FullSubNet inference (phase 24): K11 (the joint full-band / sub-band
  LSTM recurrence) at ``FullSubNetConfig()``'s widths over 820 frames (8.2 s
  at hop 160) at B = 1 and 4 against its plain joint loop, and in turns
  with the library composition of the same function (cuDNN's ``nn.LSTM``
  over the full band, the embedding, ``nn.LSTM`` over the B F bins, K11's
  weights); its producer alone and its consumers alone
  (``kernels/fsn_costs.py``); ``cli/infer``'s FullSubNet enhancer (Kalman
  stage 1) on the 8 scenes one by one, kernel route (K1 + K11) against the
  plain route. At the training shape (16 x 801 frames) K11's sequence with
  and without saving bit for bit, K9b over the sub band and the full band
  against its plain version, the route's gradients at B = 4 against the
  plain joint loop's, and its forward and backward beside the cuDNN
  composition's; K9b's split over each band beside 143f1cb's design's.
- ATT-CCRN inference (phase 25): K10 (the int8 LSTM recurrence) at the
  bottleneck's H = 4096, T = 513 against the plain int8 loop, with the count
  of h's int8 codes that differ, its time per step, where its codes lie, the
  kernel with its dots cut out and ptxas's registers and spills;
  ``cli/infer``'s ATT-CCRN enhancer (``--lstm_dtype auto``: int8 on the
  card) on the 8 scenes, kernel route (K1 + K10) against the plain route,
  and its wav SNR against the f32 route; its call timed with the codes
  cold and warm beside K10's device time in it.
- Zoo training (phase 26): two_layer_gru, dccrn, fullsubnet and att_ccrn
  at their default configs and ``TrainConfig()`` (16 scenes x 8 s) through
  ``train/generic.make_adapter`` and ``train/loop.make_stateful_train_step``:
  the first step on the kernel route (K9 and K9b twice in a DCCRN step,
  K11 once and K9b twice in a FullSubNet step, K8 and K8b once in a
  TwoLayerGRU step; no plain LSTM loop entered) against the
  plain route, TwoLayerGRU's (no switch to the plain loop) and ATT-CCRN's
  (no kernel in a batch-16 step) against the CPU route (loss, every
  gradient leaf, the new BatchNorm state); the launches of K8, K9, K11,
  K8b and K9b in validation of 8 scenes at batch 1; 3 steps timed with
  train_xrt and peak memory; a checkpoint round trip; DCT-DNN and DCT-CNN
  one step against the CPU route, timed (the DCT-CNN's H = 512 GRU on the
  wide K8 and K8b, once each a step, no plain GRU loop entered).
- Data pipeline and CLIs (phase 27): ``cli/prepare_data`` packs 8 scenes x
  8 s (train and test); an int16 ``pipeline/device_cache`` of 1,024 x 10 s
  (983 MB) built through ``_build``: its rate, its peak memory in assembly
  and 16 gathered rows against the host rows; ``train/loop.Trainer`` at
  ``TrainConfig()`` over 64 scenes (two epochs of 4 steps) from a float32
  cache against the host loader (losses, parameters), from an int16 cache,
  K8 and K8b once a step, K8 in cached validation, step ms;
  ``cli/batch_enhance`` at ``--batch 8`` (K1 / K5 and K8 once) and
  ``cli/stream`` against the same CLIs on the CPU;
  ``cli/export_pt``, then ``cli/infer`` on the ``.pt`` bit-equal to the
  ``.npz`` run; ``cli/measure`` and ``cli/profile``. The card's machine has
  no h5py: there the ``.ex`` files go through an npz-backed stand-in
  (:func:`npz_h5py`).
- The parallel layer (phase 28) at world size 1 on NCCL (one card; the
  multi-rank numbers are held on the CPU over gloo): a 1-rank group from
  ``parallel/mesh.distributed_init_if_needed``; LittleNet's, DCCRN's and
  FullSubNet's train steps with the mesh against without (K8 + K8b / K9 +
  K9b / K11 + K9b in both); ``cli/train --mesh`` and ``cli/batch_enhance --mesh --batch 8`` (K1
  / K5) against their runs without; ``parallel/tp_lstm.lstm_scan_tp`` at
  ATT-CCRN's H = 4096 against the plain scan, timed beside K10;
  ``parallel/seq_scan.pipelined_scan`` of the Kalman step; and
  ``parallel/dryrun.dryrun_multichip(1)`` in a process of its own (K3).
- The examples (phase 29, ``aec_tpu_torch/examples``): ``train_synthetic``
  through its ``main`` at 64 scenes x 4 s made on the card, 6 steps, then
  2 steps each of ``--width 4``, ``--balance`` and ``--asym 3 --sisnr
  0.2`` (K1, K8 and K8b once a step, K1 and K8 twice an evaluation), each
  checkpoint loaded by ``cli/infer.load_params`` through
  ``two_stage_cancel``; a step's split by the host clock (synthesis, stage
  1, the loss's forward and backward, the update) and its device busy
  share; stage 1 against its plain version and each recipe's step against
  the CPU route on one set of draws; ``demo_two_stage`` (K6 + K2) against
  its CPU run; ``serving_loop`` at 128 sessions x 50 blocks (K3) against
  ``serving_step_plain``.

One line per phase; the first failure exits nonzero (nothing is caught).
The second-to-last line is the ``kernels`` JSON (each kernel's launches on
its path, its error against its plain version, its time, its plain
version's time and its bound from this run's shapes; K3's rows also its
kernel's device time, ``kernel_ms``, beside the call's; K8's, K9's and
K11's also their launches in the zoo's training, ``train_launches``, K8b's
in the trainers', K8's its batched numbers, K9's and K11's their training
routes beside the library's, ``train``, K9b's at DCCRN's training shape
with FullSubNet's two passes beside; K1's,
K5's and K8's their launches on phase 27's paths, ``cli_launches``, and
K1's, K5's, K9's, K11's and K3's on phase 28's mesh routes; K1's, K8's,
K8b's, K6's, K2's and K3's on phase 29's examples, ``examples_launches``;
the wide K8's and K8b's rows, ``gru_scan_wide`` and ``gru_backward_wide``,
at the DCT-CNN's training shape with their launches in its step), the last line
the ``ok`` JSON. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# one call between two CUDA events, the card idle before it (median of reps)
from aec_tpu_torch.kernels.serving_costs import call_ms as time_ms

BATCH, N = 256, 131072  # the main path's shape: 256 utterances x 8.2 s
SR = 16000
# K1 vs plain: both fp32, other summation orders, round-off carried through
# 512 recursive block updates -> a bar of 1e-3 of the signal scale
K1_TOL = 1e-3
# K2 vs plain on the same input: fp32 round-off through DFT, GRU and pinv
# synthesis, no recursion beyond the 32-wide GRU -> 1e-4 of scale, mask 1e-5
# (on the main path also against the plain version evaluated in fp64)
K2_WAV_TOL, K2_MASK_TOL = 1e-4, 1e-5
# The mask's round-off grows with the input level and the net's gains. On
# full-scale noise through an untrained net each fp32 evaluation lands up to
# ~1.2e-5 from fp64 and K2 and the plain version up to ~1.4e-5 apart, while
# TF32 products (the lower-precision control) land 1.9e-2 to 3e-2 off: the
# mask bar there is 5e-5, and the control must stay at least 1e-3 off
K2_LOUD_MASK_TOL, K2_CONTROL_MIN = 5e-5, 1e-3
ERLE_TOL_DB = 0.1  # kernel route vs plain route, tail ERLE per scene
# K4 runs K1's FFT step and a LittleNet frame on FFTs per hop in one launch.
# Its linear_wav against K1 is held to K1's bar; its wav and mask against K2
# (the frames as FFT passes over all frames, the GRU on K8) run on K4's own
# linear_wav (the same input) to K2's bars: two fp32 evaluations of one
# function, as K2 and its plain version are.
# Against the plain composition, linear_wav is at K1's bar; wav and mask are
# K2's on an input that already differs by stage 1's round-off, which the
# sigmoid mask feels most on quiet residual frames: wav at K1's relative
# bar, mask at 1e-3
K4_WAV_TOL, K4_MASK_TOL = 1e-3, 1e-3
# One scene (bulk_delay at block 160) puts every fp32 evaluation of the
# composition, the plain one included, 5e-3 to 1.1e-2 from its fp64
# evaluation in the mask, beyond the 1e-3 bar: there, scene by scene and
# output by output where the plain fp32 composition lies farther than the
# bar from fp64, K4 is held to the fp64 evaluation, at most this many times
# the plain fp32 composition's own distance (card readings on three seeds,
# twice: K4 0.86-1.18 times it); elsewhere to the plain fp32 composition
# at the bars above. The composition with TF32 products (the control) must
# fail the same check.
K4_ILL_RATIO = 2.0
# K8 vs plain: h lies in [-1, 1]; an fp32 recursion summed in another order
K8_TOL = 1e-5
# gradients through K8 / K8b (or K9 / K11 and K9b) vs the plain route's
# autograd: the same function in fp32 in another order, carried through
# hundreds of reverse steps and sums over all rows: 1e-4 of each leaf's scale
K8_GRAD_TOL = 1e-4
# the first train step vs the same step on the CPU route: fp32 round-off of
# STFT, GRU and backward in another order -> loss rtol 1e-4; Adam's first
# update is lr * g / (|g| + eps), so each leaf's mean |difference| <= 1e-3 lr
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-4, 1e-3
N_TRAIN = 128000  # bench config #7: 8 s utterances (501 frames), batch TrainConfig().batch_size
# K3 vs plain: one Kalman block and one LittleNet frame per stream and hop,
# state carried across 68 hops and 65 calls in another summation order ->
# K1's bar of 1e-3 of scale for the output blocks and for every state leaf
K3_TOL = 1e-3
STREAM_TOL = 2e-3  # streamed == offline, of signal scale (tests/test_streaming.py:37-39)
S_SERVE, HOP = 1024, 256  # bench config concurrent_streams: S streams, one 16 ms hop per call
# K5, K6, K7 vs plain: K1's bar and reason (another summation order carried
# by the recursion), of max|mic|
STAGE1_TOL = 1e-3
N_UTT = 256000  # bench configs #1 and #2: one 16 s utterance
N_FRAC = 40 * HOP + 77  # a hop-fractional single utterance
# the other geometries the stage-1/2 kernels take: (partitions, block == hop)
GEOMETRIES = ((4, 256), (16, 256), (10, 160))
# the largest partition counts the FFT layouts hold at blocks 256 and 160,
# none below its kernel's dense layout (K6 / K7's cluster held 18 / 46 and
# 18 / 47)
LARGEST_L = {"K1": (24, 39), "K12": (24, 39), "K5": (27, 43), "K6": (29, 56), "K7": (36, 69),
             "K4": (23, 38), "K3-kalman": (23, 38), "K3-nlms": (26, 43)}
# K9 vs plain: h lies in [-1, 1]; an fp32 recursion summed in another order
K9_TOL = 1e-5
# K9b's split at 143f1cb (the design before the TMA inputs, the cluster
# exchange and the split plan): µs a step whole and with each part cut
# out, kernels/lstm_bwd_costs.py on NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md §6); phases 22 and 24 print this run's split beside it
K9B_PARENT_US = {
    "dccrn": {"full": 60.93, "no_dots": 19.79, "no_stage": 43.89, "no_wait": 59.33,
              "no_cells": 62.96},
    "fullsubnet_sub_band": {"full": 16.75, "no_dots": 6.32, "no_stage": 15.89, "no_wait": 16.67,
                            "no_cells": 12.55},
    "fullsubnet_full_band": {"full": 8.79, "no_dots": 4.23, "no_stage": 6.59, "no_wait": 8.52,
                             "no_cells": 7.60}}
K8_REGS: dict[str, str] = {}  # ptxas's lines of K8's and K8b's instantiations, set by main()
# the DCCRN enhancer, kernel route vs plain route: K1's round-off enters
# DCCRN's input, which its convolutions and recurrence carry to the wav
DCCRN_WAV_TOL = 1e-3
T_DCCRN = N // HOP + 1  # frames of one 8.2 s utterance: 513
# K11 vs plain: h in [-1, 1], an fp32 recursion summed in another order
K11_TOL = 1e-5
T_FSN = N // 160 + 1  # frames of one 8.2 s utterance at FullSubNet's hop of 160: 820
# K10 vs the plain int8 loop: the same operations in the same order, so a code
# of h flips only where a transcendental differs by an ulp near a half; a flip
# moves one h_q by 1/127, which the recurrence carries -> 1e-2 absolute
K10_TOL = 1e-2
# each enhancer, kernel route vs plain route (the DCCRN bar and reason)
ENHANCER_WAV_TOL = 1e-3
# ATT-CCRN's int8 route against its f32 route, wav SNR per scene (the JAX
# package graded 71.45-76.41 dB against bf16, benchmarks/results/ab_lstm_int8_r4.json)
INT8_SNR_MIN_DB = 60.0
# Zoo training, the first step on the kernel route against the plain route
# (or, where the step runs no kernel, the CPU route), cuDNN's TF32 off and
# its algorithms deterministic (its default backward sums with atomics: on
# an H100 the same DCCRN route run twice differs by up to 2.7e-4 of a
# gradient leaf's scale; deterministic, not at all): the loss at
# STEP_LOSS_TOL; each gradient leaf at K8's gradient bar of its scale; the
# conv biases that feed a BatchNorm have an exact gradient of zero
# (``tree_net.bias_keys_before_batch_norm``), computed as the round-off of a
# sum over ~1e6 terms at batch 16, so theirs are held within ZERO_GRAD of
# the largest leaf's scale in both routes; each BatchNorm statistic within
# STATE_TOL of its BatchNorm's scale (the largest of its statistics: a
# batch mean cancels, so its round-off follows the spread that the
# variances measure)
ZERO_GRAD, STATE_TOL = 1e-3, 1e-5
ZOO = ("two_layer_gru", "dccrn", "fullsubnet", "att_ccrn")
# Phase 27, the data pipeline and the CLIs: an int16 device cache of
# CACHE_UTTS synthetic 10 s utterances (983 MB on the card; the reference's
# corpus, 9,499 x 10 s, would be 9.1 GB there and 18 GB of float32 staged on
# the host: cut for the run's time), each gathered row within 0.55 of one
# int16 step of its host row; the cached trainer at TrainConfig() over
# DATA_UTTS 8 s scenes (two epochs of 4 steps) against the host loader from
# the same initial net: per-step losses and every parameter within CACHED_TOL
# (relative; of the leaf's scale), the same batches in the same order on the
# same kernels
CACHE_UTTS, CACHE_LEN, CACHE_STEP_TOL = 1024, 160000, 0.55
DATA_UTTS, CACHED_TOL = 64, 1e-6
# the examples (phase 29): train_synthetic at its defaults' batch (64 scenes
# x 4 s) for 6 steps, then 2 steps of each other recipe; the demo's 8 s scene;
# serving_loop's 128 sessions x 50 blocks. The demo on the card within the
# north-star 0.1 dB of its CPU run (ERLE_TOL_DB).
EX_BATCH, EX_SECONDS, EX_STEPS, EX_RECIPE_STEPS = 64, 4.0, 6, 2
EX_RECIPES = {"default": (), "width4": ("--width", "4"), "balance": ("--balance",),
              "asym_sisnr": ("--asym", "3", "--sisnr", "0.2")}
DEMO_SECONDS, SERVE_STREAMS, SERVE_BLOCKS = 8.0, 128, 50

# The least time the card could take (PERF.md section 2): the larger of the
# fp32 operations over the FFMA peak and the bytes over the HBM rate, from
# the published H100 SXM figures at 700 W.
PEAK_FP32, PEAK_HBM, PEAK_INT8 = 67e12, 3.35e12, 1979e12
L_PART, K_BINS, RI, FRAME, BANDS = 10, 257, 514, 512, 32
# FMAs of one stage-1 block step per utterance: far-frame analysis, echo
# synthesis, residual analysis, constraint head and tail over L partitions
# (the elementwise work, ~3 % more, is left out: a bound may undercount)
STAGE1_FMA = FRAME * RI + RI * HOP + HOP * RI + 2 * L_PART * RI * HOP
# one LittleNet frame: both analyses, both ERB projections, GRU input and
# hidden projections, lin1, lin2, the ERB back-projection, pinv synthesis
STAGE2_FMA = (2 * FRAME * RI + 2 * K_BINS * BANDS + 3 * BANDS * 3 * BANDS + 2 * BANDS * BANDS
              + BANDS * BANDS + K_BINS * BANDS + RI * FRAME)
STAGE1_BASES = 4 * (FRAME * RI + 2 * RI * HOP)  # fwd, inv_tail, inv_head: bytes
# The FFT step of K1 / K12 (csrc/kalman_batched.cu on csrc/fft.cuh) does less
# work for the same function: flops of one radix-R butterfly as fft.cuh
# writes it (a pass after the first also multiplies R - 1 twiddles, 6 flops
# each), of the real-FFT split per bin, and of the filter algebra per
# partition bin (predict 9, echo estimate 8, denominator 5, gain 8,
# covariance 8, constraint update 2) and per bin (psd, E / den)
DFT_FLOPS = {2: 4, 3: 16, 4: 16, 5: 48, 8: 56}
SPLIT_FLOPS, ALGEBRA_LK, ALGEBRA_K = 14, 40, 10
# NLMS's filter algebra (K5, K7): per partition bin the far power 3, echo
# estimate 8, gradient 8 and update 4; per bin the power's smoothing and
# mean 4, psd 6, the denominator and its reciprocal 6
NLMS_ALGEBRA_LK, NLMS_ALGEBRA_K = 23, 16


def complex_fft_flops(block: int) -> int:
    """Flops of one complex FFT of ``block`` points on fft.cuh's plan."""
    from aec_tpu_torch.kernels.fft_plan import radix_plan

    cfft, ns = 0, 1
    for r in radix_plan(block):
        cfft += block // r * (DFT_FLOPS[r] + (6 * (r - 1) if ns > 1 else 0))
        ns *= r
    return cfft


def stage1_fft_flops(block: int = HOP, l_part: int = L_PART, analysis: bool = True,
                     nlms: bool = False) -> int:
    """Flops of one FFT step per utterance: 2 + L forward real FFTs of 2B
    points (far frame, residual, L constraint tails; K12 skips the far
    frame), 1 + L inverse ones (echo, L constraint heads), the filter
    algebra (Kalman's, or NLMS's) and the echo subtraction."""
    cfft, k = complex_fft_flops(block), block + 1
    fwd = (1 + analysis + l_part) * (cfft + SPLIT_FLOPS * k)
    inv = (1 + l_part) * (cfft + SPLIT_FLOPS * block)
    lk, per_k = (NLMS_ALGEBRA_LK, NLMS_ALGEBRA_K) if nlms else (ALGEBRA_LK, ALGEBRA_K)
    return fwd + inv + lk * l_part * k + per_k * k + block


def stage2_fft_flops(block: int = HOP, bands: int = BANDS, erb_terms: int | None = None) -> int:
    """Flops of one LittleNet frame per utterance on K2's FFT formulation
    (what the function needs; phase C's second forward FFT of the lin frame
    is the design's and is not counted): 2 forward real FFTs of 2B points
    (lin and far frames, windowed: 2B multiplies each) and 1 inverse
    (windowed: 2B), as fft.cuh writes them; magnitudes (5 a bin and frame);
    the ERB projections over the filterbank's ``erb_terms`` nonzero weights
    (data-dependent: the ERB matrix's support; all K E if not given), the
    gain over them and y = gain X (2 K); the GRU's input and hidden
    projections (6 E^2 + 3 E^2 FMA) and cell (~12 E); lin1 and lin2 (3 E^2
    FMA); the OLA (3 B)."""
    cfft, k = complex_fft_flops(block), block + 1
    nz = k * bands if erb_terms is None else erb_terms
    fft = 2 * (cfft + SPLIT_FLOPS * k + 2 * block) + cfft + SPLIT_FLOPS * block + 2 * block
    small = 2 * (2 * nz + nz + 12 * bands * bands) + 2 * k + 12 * bands
    return fft + 5 * 2 * k + small + 3 * block


STAGE2_BASES = 4 * (FRAME * RI + RI * FRAME + 2 * K_BINS * BANDS + 12 * BANDS * BANDS)
# K2's own constants: window, twiddles, erb and its transpose, the weights
STAGE2_FFT_CONSTS = 4 * (2 * FRAME + 2 * K_BINS * BANDS + 12 * BANDS * BANDS)


def hop_flops(erb_terms: int, l_part: int = L_PART) -> int:
    """Flops of one two-stage hop of K3 / K4 (csrc/hop.cuh) per stream on
    FFTs: K1's FFT step and one LittleNet frame on K2's FFT formulation."""
    return stage1_fft_flops(l_part=l_part) + stage2_fft_flops(erb_terms=erb_terms)


def serving_bounds(streams: int, state_bytes: int, erb_terms: int) -> tuple[dict, dict]:
    """K3's bound for one one-hop call of ``streams`` streams: on the FFT
    hop's flops, its bytes the state round trip (``state_bytes`` a stream,
    read and written once), far and mic in, out, and the constants (the
    twiddles, window and stage-2 weights); and on the dense formulation's
    FMAs with its bases, for comparison."""
    io = 3 * 4 * streams * HOP + 2 * streams * state_bytes
    fft = bound(streams * hop_flops(erb_terms) / 2, io + 4 * FRAME + STAGE2_FFT_CONSTS)
    return fft, bound(streams * (STAGE1_FMA + STAGE2_FMA), io + STAGE1_BASES + STAGE2_BASES)


def two_stage_bounds(batch: int, erb_terms: int) -> tuple[dict, dict]:
    """K4's bound for ``batch`` utterances of N samples: T FFT hops and the
    flush frame (far and mic in, wav, linear_wav and the mask out, the
    constants); and the dense formulation's, for comparison."""
    t = N // HOP
    io = 4 * batch * N * 4 + batch * (t + 1) * BANDS * 4
    flops = batch * (t * hop_flops(erb_terms) + stage2_fft_flops(erb_terms=erb_terms))
    fft = bound(flops / 2, io + 4 * FRAME + STAGE2_FFT_CONSTS)
    return fft, bound(batch * (t * STAGE1_FMA + (t + 1) * STAGE2_FMA),
                      io + STAGE1_BASES + STAGE2_BASES)


def fsn_bound(b: int, t: int, f: int = 161, hf: int = 256, hs: int = 96) -> dict:
    """K11's: per frame the full-band, embedding, sub-band and embedding-column
    FMAs; xp_fb, xp_sb, the weights in, ys out."""
    fma = t * b * (4 * hf * hf + f * hf + f * 4 * hs * hs + f * 4 * hs)
    return bound(fma, 4 * (b * t * (4 * hf + f * 4 * hs + f * hs)
                           + 4 * hf * hf + f * hf + f + 4 * hs + 4 * hs * hs))


def int8_bound(b: int, t: int, h: int) -> dict:
    """K10's: B T 4H H int8 MACs at the int8 peak; the codes (1 B each),
    xp, scale, b_hh, h0, c0 in, ys and c_T out (fp32)."""
    return bound(b * t * 4 * h * h, 4 * h * h + 4 * (b * t * 4 * h + 2 * 4 * h + 3 * b * h
                                                     + b * t * h), PEAK_INT8)


def time_once(fn) -> float:
    """One run of ``fn`` on CUDA events (for plain loops too slow to repeat;
    the comparison run before it was the warm-up)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def stage1_bounds(batch: int, analysis: bool = True, nlms: bool = False,
                  n: int = N) -> tuple[dict, dict]:
    """K1's bound (K12's without the analysis; K5's with NLMS's algebra; K6's
    and K7's at batch 1) for ``batch`` utterances of ``n`` samples: on the
    FFT step's flops (far blocks or spectra, mic in, e out, the twiddle
    table), and on the dense DFT formulation's FMAs (its bases read once)
    for comparison."""
    t = n // HOP
    x_bytes = 4 * batch * (n if analysis else t * RI)
    io = x_bytes + 2 * 4 * batch * n
    fft = bound(batch * t * stage1_fft_flops(analysis=analysis, nlms=nlms) / 2, io + 4 * FRAME)
    dense_fma = STAGE1_FMA if analysis else STAGE1_FMA - FRAME * RI
    return fft, bound(batch * t * dense_fma, io + STAGE1_BASES)


def stage2_bounds(batch: int, n: int, erb_terms: int) -> tuple[dict, dict]:
    """K2's bound for ``batch`` utterances of ``n`` samples: on its FFT
    formulation's flops (lin and far in, out and the mask out, its
    constants), and on the dense DFT formulation's FMAs (its bases read
    once) for comparison."""
    frames = n // HOP + 1
    io = 3 * 4 * batch * n + 4 * batch * frames * BANDS
    fft = bound(batch * frames * stage2_fft_flops(erb_terms=erb_terms) / 2, io + STAGE2_FFT_CONSTS)
    return fft, bound(batch * frames * STAGE2_FMA, io + STAGE2_BASES)


def k8_registers(log: str) -> list[tuple[str, str]]:
    """K8's and K8b's one-CTA instantiations in the gru build log: (the
    kernel, its lanes per unit P and weights per lane and gate C, for K8b
    the chunks of W a lane keeps in shared memory, ptxas's registers and
    spill line)."""
    out, plan, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"gru_(bwd_)?kernelILi(\d+)ELi(\d+)E(?:Li(\d+)E)?(Lb1)?", line)
        if m:
            kernel = "K8b" if m.group(1) else "K8 saving the gates" if m.group(5) else "K8"
            plan, spill = f"{kernel} P = {m.group(2)}, C = {m.group(3)}", ""
            if m.group(4):  # K8b's float4 chunks of W a lane in shared memory
                plan += f", {m.group(4)} chunks of W in shared memory"
        elif plan and "spill" in line:
            spill = line.split(":")[-1].strip()
        elif plan and "registers" in line:
            out.append((plan, f"{line.split(':', 1)[1].strip()}; {spill}"))
            plan = None
    return out


def k8b_h128_registers() -> str:
    """ptxas's line for K8b's H = 128 instantiation (P = 4, C = 32)."""
    return next((f"{k}: {v}" for k, v in K8_REGS.items() if k.startswith("K8b P = 4, C = 32")),
                "not found")


def gru_bound(b: int, t: int, h: int) -> dict:
    """K8's: B*T*3H*H FMA; xp in, ys out, W_hh^T, b_hn, h0 and h_T."""
    return bound(b * t * 3 * h * h, 4 * (b * t * 4 * h + 3 * h * h + h + 2 * b * h))


def k8b_bound(b: int, t: int, h: int) -> dict:
    """K8b's: B*T*3H*H FMA (the forward's dots, transposed); g_ys, ys and
    the saved gates (4H) in, dxp (3H) and d_hn out, W_hh, h0 and dh0."""
    return bound(b * t * 3 * h * h, 4 * (b * t * 10 * h + 3 * h * h + 2 * b * h))


def k9b_bound(rows: int, t: int, h: int) -> dict:
    """K9b's: rows T 4H H FMA (the forward's dots, transposed); g_ys (H),
    the saved gates and c (5H) in and dxp (4H) out a row-step, W_hh once a
    row's group (counted once)."""
    return bound(rows * t * 4 * h * h, 4 * (rows * t * 10 * h + 4 * h * h))


def in_turns(fns, reps: int) -> list[list[float]]:
    """Each of ``fns`` timed four times in turns (forwards, backwards,
    forwards, backwards): per fn its four ms."""
    turns = [time_ms(fn, reps) for fn in fns + fns[::-1] + fns + fns[::-1]]
    n = len(fns)
    return [[turns[i], turns[2 * n - 1 - i], turns[2 * n + i], turns[4 * n - 1 - i]]
            for i in range(n)]


class plain_entries:
    """Counts the calls into the plain recurrences and K9b's plain version
    that the LSTM routes reach through their modules' names (the grouped
    scan and its loop, the joint loop, the plain backward), and into the
    GRU's plain loop (a step of ``ops.gru.gru_scan``'s loop) and K8's and
    K8b's plain versions: a route on the card enters none of them (``with
    plain_entries() as n: ...; n[0]``)."""

    def __enter__(self):
        from aec_tpu_torch.kernels import gru as kg
        from aec_tpu_torch.kernels import lstm as kl
        from aec_tpu_torch.kernels import lstm_bwd as kb
        from aec_tpu_torch.models import fullsubnet as mf
        from aec_tpu_torch.ops import gru as og
        from aec_tpu_torch.ops import lstm as ol

        self.count = [0]
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (kl, "complex_lstm_scan"), (kl, "grouped_lstm_recurrence_plain"),
            (ol, "grouped_lstm_recurrence_plain"), (kb, "lstm_backward_plain"),
            (mf, "_joint_scan_hs"), (og, "gru_cell"), (kg, "gru_recurrence_plain"),
            (kg, "gru_backward_plain"))]

        def counted(fn):
            def call(*a, **k):
                self.count[0] += 1
                return fn(*a, **k)
            return call

        for m, n, fn in self.saved:
            setattr(m, n, counted(fn))
        return self.count

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def bound(fma: float, nbytes: float, peak: float = PEAK_FP32) -> dict:
    """``bound_ms`` and ``bound_by`` of the kernels JSON: ``fma``
    multiply-adds (or half as many flops) at ``peak`` operations per second
    (fp32 unless named)."""
    t_ops, t_bytes = 2 * fma / peak * 1e3, nbytes / PEAK_HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def pipelined_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` run ``reps`` times back to back between two
    CUDA events, after a warm-up: the host enqueues ahead of the card, so
    a call costs its device time, not the host's share of a lone call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_batch(dev, seed: int, b: int, n: int):
    """Far-end noise through a random decaying 512-tap echo path per
    utterance, plus a low near-end noise floor; made on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    far = torch.randn(b, n, generator=g, device=dev)
    rir = torch.randn(b, 512, generator=g, device=dev)
    rir = rir * torch.exp(-torch.arange(512, device=dev) / 100.0)
    rir = 0.5 * rir / rir.abs().amax(-1, keepdim=True)
    nfft = n + 512
    echo = torch.fft.irfft(torch.fft.rfft(far, nfft) * torch.fft.rfft(rir, nfft), nfft)[:, :n]
    mic = echo + 0.01 * torch.randn(b, n, generator=g, device=dev)
    return far.contiguous(), mic.contiguous()


def state_err(got: dict, want: dict) -> tuple[str, float]:
    """The serving-state leaf (``nm`` row by row) with the largest
    max|got - want| relative to the leaf's own scale, and that ratio."""
    pairs = {k: (got[k], want[k]) for k in want if k != "nm"}
    pairs.update({f"nm[{r}]": (got["nm"][:, r], want["nm"][:, r]) for r in range(8)})
    errs = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-9)
            for k, (a, b) in pairs.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


class NpzH5Node:
    """A file or group of :func:`npz_h5py`'s stand-in: datasets are numpy
    arrays keyed by their path in the file."""

    def __init__(self, data: dict, prefix: str = ""):
        self.data, self.prefix = data, prefix

    def create_dataset(self, name, data, **_):
        self.data[self.prefix + name] = np.array(data)

    def create_group(self, name):
        return NpzH5Node(self.data, f"{self.prefix}{name}/")

    def __getitem__(self, name):
        key = self.prefix + name
        return self.data[key] if key in self.data else NpzH5Node(self.data, key + "/")

    def __len__(self):
        return len({k[len(self.prefix):].split("/")[0] for k in self.data
                    if k.startswith(self.prefix)})


class NpzH5File(NpzH5Node):
    def __init__(self, path: str, mode: str = "r"):
        self.path, self.mode = path, mode
        if mode == "r":
            with np.load(path) as z:
                super().__init__({k: z[k] for k in z.files})
        else:
            super().__init__({})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.mode == "w" and exc[0] is None:
            with open(self.path, "wb") as f:
                np.savez(f, **self.data)


def npz_h5py():
    """A stand-in for the h5py calls ``pipeline/h5io`` makes (``File``,
    ``create_dataset``, ``create_group``, indexing, ``len``), storing each
    file's datasets in one npz archive under the file's name. The card's
    machine has no h5py, so phase 27 installs it as ``h5py`` there to drive
    the file paths (prepare_data, the trainer's loaders, device_cache,
    batch_enhance); the h5 format itself is held to JAX's on the CPU
    (``tests/test_torch_data.py``)."""
    import types

    return types.SimpleNamespace(File=NpzH5File)


def drive(kernels, fn):
    """The contract of a path's run: every launch count set to 0 just before
    ``fn`` drives the path, read just after; -> (fn's result, the counts)."""
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [k.launches for k in kernels]


def serve_pair(net, erb, far, mic, k_calls, stage1="kalman", hop=HOP, **kw):
    """K3 and serving_step_plain side by side over ``k_calls`` (a list of
    blocks per call); returns both states, the worst output max|d| relative
    to its call's output scale, and the worst max|d| itself. ``kw`` may
    name the filter's ``kcfg`` and the ``scfg`` of a ``hop``-sample STFT."""
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain

    s = far.shape[0]
    geometry = {k: kw[k] for k in ("kcfg", "scfg") if k in kw}
    ks, ps = (serving_init(s, stage1=stage1, device=far.device, **geometry) for _ in range(2))
    kw["stage1"] = stage1
    rel, err, lo = 0.0, 0.0, 0
    for k in k_calls:
        fb, mb = far[:, lo : lo + k * hop].contiguous(), mic[:, lo : lo + k * hop].contiguous()
        ks, ok = serving_step_fused(net, ks, fb, mb, erb, **kw)
        ps, op = serving_step_plain(net, ps, fb, mb, erb, **kw)
        check(ok.shape == (s, k * hop) and bool(torch.isfinite(ok).all()), "K3 output")
        d = float((ok - op).abs().max())
        rel, err = max(rel, d / max(float(op.abs().max()), 1e-9)), max(err, d)
        lo += k * hop
    return ks, ps, rel, err


def cache_phase(net, erb, far, mic) -> None:
    """8a. K3's prepared constants follow the weights: 4 one-hop calls of 8
    streams on a copy of the net, two of its weights changed in place before
    the third (as an optimizer step or ``load_state_dict`` changes them),
    each call against the plain version with the weights of the moment; the
    change must move the output by more than the bar, so a launch on stale
    constants would fail."""
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-9)

    mine, s = copy.deepcopy(net), 8
    ks, ps = (serving_init(s, device=far.device) for _ in range(2))
    errs, moved = [], 0.0
    with torch.no_grad():
        for u in range(4):
            fb = far[:s, u * HOP:(u + 1) * HOP].contiguous()
            mb = mic[:s, u * HOP:(u + 1) * HOP].contiguous()
            if u == 2:
                mine.linear2.bias.add_(0.5)
                mine.gru1.weight_hh_l0.mul_(0.9)
                before = {k: v.clone() for k, v in ps.items()}
                _, stale = serving_step_plain(net, before, fb, mb, erb)
            ks, ok = serving_step_fused(mine, ks, fb, mb, erb)
            ps, op = serving_step_plain(mine, ps, fb, mb, erb)
            errs.append(rel(ok, op))
            if u == 2:
                moved = rel(op, stale)
        leaf, leaf_rel = state_err(ks, ps)
    phase("K3 vs plain", f"weights changed in place after 2 calls: out {max(errs):.3e}, worst "
          f"state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g}); the change moved the output by "
          f"{moved:.3e} of scale")
    check(max(errs) <= K3_TOL and leaf_rel <= K3_TOL and moved > 10 * K3_TOL,
          "K3 did not follow an in-place change to the weights")


def leaves(tree) -> list[np.ndarray]:
    """A checkpoint tree's leaves in path order, as numpy arrays."""
    from aec_tpu_torch.train.checkpoints import tree_map_with_path

    out = []
    tree_map_with_path(tree, lambda _, v: out.append(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)))
    return out


def gru_phase(dev, seed: int, reps: int, smi: str, wide_libs: dict) -> dict:
    """16. K8 vs its plain version and beside cuDNN's nn.GRU (same weights,
    fp32) at one 16 s utterance (B = 1, T = 1001) for H = 32, 64 and 128 (one
    CTA per row, W_hh in registers) and 129 and 512 (the wide path, its ys
    also with the gates saved, bit for bit), and at the batches users run, B
    = 8 (``batch_enhance --batch 8``) and 16 (the training batch), T = 501,
    H = 32, and B = 16 at H = 64 (TwoLayerGRU), 128 and 512 (the DCT-CNN's
    GRU, on the wide path), where ``gru_scan`` routes to K8 and K8b
    (:func:`gru_batch_phase`); then the wide kernels whole and without
    their dots (``kernels/gru_wide_costs.py``). Timed in turns: cuDNN, the recurrence alone
    (``gru_recurrence`` on the folded projection), the whole forward
    ``gru_scan_fused`` (projection and recurrence: the same function as
    ``nn.GRU(x, h0)``), cuDNN; then the same four with calls back to back
    (``pipelined_ms``), which leaves out the host's share of a lone call."""
    from aec_tpu_torch.kernels.gru import (
        folded_projection,
        gru_recurrence,
        gru_recurrence_plain,
        gru_scan_fused,
    )
    from aec_tpu_torch.kernels import gru_wide_costs
    from aec_tpu_torch.ops.gru import gru_init

    g = torch.Generator().manual_seed(seed)
    out = {"err": 0.0, "bwd_err": 0.0, "wide_err": 0.0, "wide_bwd_err": 0.0, "shapes": {}}
    for b, t, h in ((1, 1001, 32), (1, 1001, 64), (1, 1001, 128), (1, 1001, 129),
                    (1, 1001, 512), (8, 501, 32), (16, 501, 32), (16, 501, 64), (16, 501, 128),
                    (16, 501, 512)):
        wide = "wide_" if h > 128 else ""
        params = gru_init(2 * BANDS, h, generator=g, device=dev)
        x = torch.randn(b, t, 2 * BANDS, generator=g).to(dev)
        h0 = torch.zeros(b, h, device=dev)
        gru = torch.nn.GRU(2 * BANDS, h, batch_first=True).to(dev)
        with torch.no_grad():
            for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                              ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                getattr(gru, name).copy_(params[key])
            xp, b_hn = folded_projection(params, x), params["b_hh"][2 * h:]
            ys = gru_recurrence(xp, params["w_hh"], b_hn, h0)
            want = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0)
            lib = gru(x, h0[None])[0]
            torch.cuda.synchronize()
            check(ys.shape == (b, t, h) and bool(torch.isfinite(ys).all()), "K8 output")
            if wide and b == 1:  # the batches check it in gru_batch_phase
                check(torch.equal(ys, gru_recurrence(xp, params["w_hh"], b_hn, h0, save=True)[0]),
                      "the wide K8's ys change with the save flag")
            err = float((ys - want).abs().max())
            lib_err = float((lib - want).abs().max())
            turns = [time_ms(fn, reps) for fn in (
                lambda: gru(x, h0[None]),
                lambda: gru_recurrence(xp, params["w_hh"], b_hn, h0),
                lambda: gru_scan_fused(params, x, h0),
                lambda: gru(x, h0[None]))]
            t_k, t_f, t_lib = turns[1], turns[2], (turns[0] + turns[3]) / 2
            t_p = time_ms(lambda: gru_recurrence_plain(xp, params["w_hh"], b_hn, h0), reps)
            piped = [pipelined_ms(fn, 4 * reps) for fn in (
                lambda: gru(x, h0[None]),
                lambda: gru_recurrence(xp, params["w_hh"], b_hn, h0),
                lambda: gru_scan_fused(params, x, h0),
                lambda: gru(x, h0[None]))]
        phase("K8 vs plain", f"B = {b}, T = {t}, H = {h}: max|d| = {err:.3e} (bar {K8_TOL:g}); "
              f"cuDNN nn.GRU vs plain {lib_err:.3e} (information)")
        check(err <= K8_TOL, "K8 disagrees with its plain version")
        bnd = gru_bound(b, t, h)
        phase("time", f"K8 B = {b}, T = {t}, H = {h}: recurrence {t_k:.4f} ms, whole forward "
              f"gru_scan_fused {t_f:.4f} ms; cuDNN nn.GRU {turns[0]:.4f} / {turns[3]:.4f} ms (in "
              f"turns); ratio to cuDNN: recurrence {t_k / t_lib:.3f}, whole forward "
              f"{t_f / t_lib:.3f}; plain {t_p:.2f} ms; bound {bnd['bound_ms']:.5f} ms "
              f"({bnd['bound_by']}) [{smi}]")
        p_lib = (piped[0] + piped[3]) / 2
        phase("time", f"K8 B = {b}, T = {t}, H = {h}, {4 * reps} calls back to back (device "
              f"time): recurrence {piped[1]:.4f} ms, whole forward {piped[2]:.4f} ms; cuDNN "
              f"{piped[0]:.4f} / {piped[3]:.4f} ms; ratio to cuDNN {piped[1] / p_lib:.3f}, "
              f"{piped[2] / p_lib:.3f} [{smi}]")
        out[wide + "err"] = max(out[wide + "err"], err)
        out["shapes"][(b, t, h)] = {"ms": t_k, "fused_ms": t_f, "plain_ms": t_p,
                                    "library_ms": t_lib}
        if b > 1:
            row = gru_batch_phase(params, x, h0, gru, reps, smi, seed + b + h)
            out[wide + "bwd_err"] = max(out[wide + "bwd_err"], row.pop("k8b_err"))
            out["shapes"][(b, t, h)].update(row)
    with torch.no_grad():
        out["wide_costs"] = gru_wide_costs.costs(wide_libs, reps, seed)
    for row in out["wide_costs"]:
        phase("K8 wide costs", f"{gru_wide_costs.report(row)} [{smi}]")
    return out


def gru_batch_phase(params, x, h0, gru, reps: int, smi: str, seed: int) -> dict:
    """16 at B > 1, the route users train and enhance on (K8, and K8b in
    the backward): K8's ys with and without saving the gates, bit for bit;
    K8b against its plain version on those gates, and the route's gradients
    into every leaf (x, h0, the four parameters) against the recompute
    route's (the plain loop), each at K8's gradient bar of its scale, with
    the launches of both routes; then in turns, each four times: cuDNN's
    forward, the route's forward, cuDNN's forward and backward, the route's
    forward and backward (``torch.autograd.grad`` of a fixed cotangent into
    every leaf; cuDNN with the same weights); the backwards alone (cuDNN's
    and the route's of a recorded forward, K8b on saved gates); the plain
    versions, K8b's and the plain route's forward and backward, fewer reps."""
    from aec_tpu_torch.kernels.gru import (
        folded_projection,
        gru_backward,
        gru_backward_plain,
        gru_recurrence,
    )
    from aec_tpu_torch.ops.gru import gru_scan

    b, t, _ = x.shape
    h = h0.shape[-1]
    cot = torch.randn(b, t, h, generator=torch.Generator().manual_seed(seed)).to(x.device)
    w_hh, b_hn = params["w_hh"], params["b_hh"][2 * h:]
    with torch.no_grad():
        xp = folded_projection(params, x)
        ys = gru_recurrence(xp, w_hh, b_hn, h0)
        ys_s, gates = gru_recurrence(xp, w_hh, b_hn, h0, save=True)
        got = gru_backward(cot, gates, ys_s, h0, w_hh)
        torch.cuda.synchronize()
        want = gru_backward_plain(cot, gates, ys_s, h0, w_hh)
    same = torch.equal(ys, ys_s)
    k8b_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    k8b_rel = max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want))

    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    xl, hl = x.detach().clone().requires_grad_(), h0.detach().clone().requires_grad_()
    order = [xl, hl, *leaves.values()]

    def fwd_bwd(fused=None):
        ys_r, _ = gru_scan(leaves, xl, hl, fused=fused)
        return torch.autograd.grad(ys_r, order, cot)

    grads, counts = {}, {}
    for fused in (None, False):
        grads[fused], counts[fused] = drive((gru_recurrence, gru_backward),
                                            lambda: fwd_bwd(fused))
    route_rel = max(float((a - w).abs().max() / w.abs().max())
                    for a, w in zip(grads[None], grads[False]))
    phase("K8b vs plain", f"B = {b}, T = {t}, H = {h}: K8's ys with and without saving the "
          f"gates bit-equal {same}; K8b vs its plain version, worst of dxp / d_hn / dh0 max|d| "
          f"/ scale {k8b_rel:.3e} (max|d| {k8b_err:.3e}); the route's gradients vs the plain "
          f"route's, worst leaf {route_rel:.3e} (bars {K8_GRAD_TOL:g}); launches K8 / K8b: "
          f"route {counts[None]}, plain route {counts[False]}")
    check(same, "K8's ys change with the save flag")
    check(k8b_rel <= K8_GRAD_TOL, "K8b disagrees with its plain version")
    check(counts[None] == [1, 1] and counts[False] == [0, 0],
          "gru_scan did not route to K8 and K8b at this batch")
    check(route_rel <= K8_GRAD_TOL, "the route's gradients disagree with the plain route's")

    lib_leaves = [xl, hl, *gru.parameters()]

    def lib_fwd_bwd():
        return torch.autograd.grad(gru(xl, hl[None])[0], lib_leaves, cot)

    def route_fwd():
        with torch.no_grad():
            return gru_scan(params, x, h0)

    def lib_fwd():
        with torch.no_grad():
            return gru(x, h0[None])

    fns = (lib_fwd, route_fwd, lib_fwd_bwd, fwd_bwd)
    turns = [time_ms(fn, reps) for fn in fns + fns[::-1] + fns + fns[::-1]]
    pairs = [[turns[i], turns[7 - i], turns[8 + i], turns[15 - i]] for i in range(4)]
    ys_lib = gru(xl, hl[None])[0]
    ys_route, _ = gru_scan(leaves, xl, hl)
    bwd = (lambda: torch.autograd.grad(ys_lib, lib_leaves, cot, retain_graph=True),
           lambda: gru_backward(cot, gates, ys_s, h0, w_hh),
           lambda: torch.autograd.grad(ys_route, order, cot, retain_graph=True))
    bturns = [time_ms(fn, reps) for fn in bwd + bwd[::-1]]
    bpairs = [[bturns[i], bturns[5 - i]] for i in range(3)]
    t_pb = time_ms(lambda: gru_backward_plain(cot, gates, ys_s, h0, w_hh), 2)
    t_plain = time_ms(lambda: fwd_bwd(False), 2)
    med = [statistics.median(p) for p in pairs]
    bmed = [statistics.median(p) for p in bpairs]
    fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)  # noqa: E731
    phase("time", f"B = {b}, T = {t}, H = {h}, in turns (4 each, ms): forward cuDNN {fmt(pairs[0])}, "
          f"the route (K8) {fmt(pairs[1])}; forward and backward cuDNN {fmt(pairs[2])}, the route "
          f"(K8 + K8b) {fmt(pairs[3])}; ratio to cuDNN, medians: forward {med[1] / med[0]:.3f}, "
          f"forward and backward {med[3] / med[2]:.3f} [{smi}]")
    phase("time", f"B = {b}, T = {t}, H = {h}, the backwards alone (ms, in turns): cuDNN "
          f"{fmt(bpairs[0])}, the route's {fmt(bpairs[2])}, K8b {fmt(bpairs[1])} (plain "
          f"{t_pb:.2f}); the plain route's forward and backward {t_plain:.1f} ms; K8b's bound "
          f"{k8b_bound(b, t, h)['bound_ms']:.5f} ms [{smi}]")
    if h == 128:  # the plan with gate n's tail chunks of W in shared memory
        phase("K8b at H = 128", f"B = {b}, T = {t}: K8b {bmed[1]:.4f} ms, cuDNN's backward alone "
              f"{bmed[0]:.4f} ms; {k8b_h128_registers()} [{smi}]")
    return {"k8b_err": k8b_err, "route_fwd_ms": med[1], "lib_fwd_ms": med[0],
            "route_fwd_bwd_ms": med[3], "lib_fwd_bwd_ms": med[2], "lib_bwd_ms": bmed[0],
            "k8b_ms": bmed[1], "route_bwd_ms": bmed[2], "k8b_plain_ms": t_pb,
            "plain_fwd_bwd_ms": t_plain}


def trainer_phase(dev, seed: int, reps: int, smi: str) -> dict:
    """17-18. The gradients through K8 and K8b against the plain route on
    one 8 s scene and on 16; the trainer at TrainConfig() on 16 utterances
    x 8 s (bench config #7): 5 batch-16 steps (K8 and K8b once each; the
    first against the CPU route), validation at batch 1 over 8 scenes (K8),
    a checkpoint round trip, 3 batch-1 steps (K8 and K8b)."""
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.gru import gru_backward, gru_recurrence
    from aec_tpu_torch.models.little_net import (
        _pseudo_norm,
        little_net_features,
        little_net_init,
        little_net_loss,
    )
    from aec_tpu_torch.ops.gru import gru_scan
    from aec_tpu_torch.train import checkpoints
    from aec_tpu_torch.train.loop import (
        make_eval_step,
        make_optimizer,
        make_train_step,
        restore_train_tree,
        train_tree,
    )
    from benchmarks.scenes import make_scenes

    cfg = TrainConfig()
    scenes = [sc for sd in (seed, seed + 1)
              for sc in make_scenes(np.random.default_rng(sd), n=N_TRAIN).values()]
    far, mic, near = (torch.from_numpy(np.stack([sc[i] for sc in scenes])) for i in range(3))
    fd, md, nd = far.to(dev), mic.to(dev), near.to(dev)
    erb_c = torch.from_numpy(erb_filterbank())
    erb_d = erb_c.to(dev)
    net = little_net_init(generator=torch.Generator().manual_seed(seed), device=dev)
    cpu_net = little_net_init(generator=torch.Generator().manual_seed(seed), device="cpu")

    # 17. gradients through K8 and K8b vs the plain route: the GRU of the
    #     fresh net on one scene's features and on 16 scenes', a fixed random
    #     cotangent, every leaf
    for b in (1, cfg.batch_size):
        with torch.no_grad():
            feats = little_net_features(_pseudo_norm(md[:b]), _pseudo_norm(fd[:b]), erb_d,
                                        StftConfig())[0]
        gp = {k: v.detach().clone().requires_grad_() for k, v in net.gru_params().items()}
        feats.requires_grad_()
        cot = torch.randn(b, feats.shape[1], net.hidden,
                          generator=torch.Generator().manual_seed(seed)).to(dev)
        grads, launches = {}, {}

        def fwd_bwd(fused):
            ys, _ = gru_scan(gp, feats, fused=fused)
            return torch.autograd.grad((ys * cot).sum(), [feats, *gp.values()])

        for fused in (None, False):
            grads[fused], launches[fused] = drive((gru_recurrence, gru_backward),
                                                  lambda: fwd_bwd(fused))
        worst = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-12)
                    for a, c in zip(grads[None], grads[False]))
        phase("K8 gradients", f"{b} x {feats.shape[1]} frames: launches K8 / K8b {launches[None]} "
              f"(plain route {launches[False]}); worst leaf max|d| / scale = {worst:.3e} (bar "
              f"{K8_GRAD_TOL:g})")
        check(launches[None] == [1, 1] and launches[False] == [0, 0],
              f"the batch-{b} route did not take K8 and K8b")
        check(worst <= K8_GRAD_TOL, "gradients through K8 and K8b disagree with the plain route")

    # 18. the trainer: 5 steps at batch 16, the first also on the CPU route
    opt, cpu_opt = make_optimizer(cfg, 1, net), make_optimizer(cfg, 1, cpu_net)
    step, cpu_step = make_train_step(little_net_loss, opt), make_train_step(little_net_loss, cpu_opt)
    losses, times, step_counts = [], [], []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, counts = drive((gru_recurrence, gru_backward),
                             lambda: float(step(md, fd, nd, erb_d)))  # float() waits for the card
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        step_counts.append(counts)
        if i == 0:
            cpu_loss = float(cpu_step(mic, far, near, erb_c))
            mean_d = max(float((p.detach().cpu() - q.detach()).abs().mean())
                         for p, q in zip(net.parameters(), cpu_net.parameters()))
            rel = abs(losses[0] / cpu_loss - 1.0)
            phase("trainer", f"step 1, batch {cfg.batch_size} x {N_TRAIN}: loss {losses[0]:.6f} "
                  f"(CPU route {cpu_loss:.6f}, rel {rel:.2e}, bar {STEP_LOSS_TOL:g}); worst leaf "
                  f"mean|d| after the update {mean_d:.3e} (bar {STEP_PARAM_TOL:g} x lr = "
                  f"{STEP_PARAM_TOL * cfg.lr:.1e})")
            check(rel <= STEP_LOSS_TOL and mean_d <= STEP_PARAM_TOL * cfg.lr,
                  "the first train step disagrees with the CPU route")
    check(all(np.isfinite(losses)), "train loss not finite")
    check(all(c == [1, 1] for c in step_counts), f"a train step did not launch K8 and K8b once "
          f"each: {step_counts}")
    t_step = statistics.median(times[1:])
    train_xrt = cfg.batch_size * N_TRAIN / SR / (t_step / 1e3)
    phase("trainer", f"launches K8 / K8b a step {step_counts[0]}; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step ms "
          f"{', '.join(f'{v:.1f}' for v in times)}; median of steps 2-5 {t_step:.2f} ms = "
          f"train_xrt {train_xrt:.1f} [{smi}]")

    eval_step = make_eval_step(little_net_loss)

    def validate():
        return [eval_step(net, md[i:i + 1], fd[i:i + 1], nd[i:i + 1], erb_d) for i in range(8)]

    vals, (k8_val,) = drive((gru_recurrence,), validate)
    check(k8_val > 0, "batch-1 validation did not go through K8")
    check(all(bool(torch.isfinite(w).all()) and w.shape == (1, N_TRAIN) and bool(torch.isfinite(v))
              for v, w in vals), "validation output")
    t_val = time_ms(validate, reps) / 8
    phase("trainer", f"validation, 8 scenes at batch 1: launches K8 {k8_val}; cv loss "
          f"{np.mean([float(v) for v, _ in vals]):.4f}; {t_val:.2f} ms per utterance [{smi}]")

    with tempfile.TemporaryDirectory() as d:
        tree = train_tree(opt)
        latest = checkpoints.save_latest_best(d, tree, {"cur_epoch": 0}, True)
        want, got = leaves(tree), leaves(checkpoints.restore(latest, tree))
        same = len(want) == len(got) and all(np.array_equal(a, b) for a, b in zip(want, got))
        fresh = little_net_init(generator=torch.Generator().manual_seed(seed + 7), device=dev)
        fresh_opt = make_optimizer(cfg, 1, fresh)
        restore_train_tree(os.path.join(d, "best_loss.npz"), fresh_opt)
        same_net = all(torch.equal(a, b) for a, b in zip(net.parameters(), fresh.parameters()))
    phase("trainer", f"save_latest_best -> restore: {len(want)} leaves bit-equal {same}; "
          f"resumed net bit-equal {same_net}, count {fresh_opt.count}")
    check(same and same_net and fresh_opt.count == opt.count, "checkpoint round trip")

    def batch_one_steps():
        return [float(step(md[i:i + 1], fd[i:i + 1], nd[i:i + 1], erb_d)) for i in range(3)]

    b1_losses, (k8_b1, k8b_b1) = drive((gru_recurrence, gru_backward), batch_one_steps)
    check(k8_b1 > 0 and k8b_b1 > 0 and all(np.isfinite(b1_losses)),
          "batch-1 steps did not go through K8 and K8b")
    t_b1 = time_ms(lambda: step(md[3:4], fd[3:4], nd[3:4], erb_d), reps)
    phase("trainer", f"3 batch-1 steps: launches K8 {k8_b1}, K8b {k8b_b1}, losses "
          f"{', '.join(f'{v:.4f}' for v in b1_losses)}; {t_b1:.2f} ms per step [{smi}]")
    print(f"train_step_ms={t_step:.3f} train_xrt={train_xrt:.1f} train_step_b1_ms={t_b1:.3f} "
          f"validate_ms_per_utt={t_val:.3f}", flush=True)
    return {"k8_val": k8_val, "k8b_steps": sum(c[1] for c in step_counts),
            "step_ms": t_step, "train_xrt": train_xrt}


def geometry_phase(dev, net, names, s_far, s_mic, smi: str) -> None:
    """21. The stage-1/2 kernels at other geometries on the 8 scenes (cut to
    a block multiple), each against its plain version at the default
    geometry's bars; two_stage_cancel's routes at each, against the plain
    route in tail ERLE. One path per geometry and route: counts set to 0,
    driven, read."""
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
    )
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.serving import serving_step_fused
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain
    from aec_tpu_torch.kernels.two_stage import two_stage_fused
    from aec_tpu_torch.linear import overlap_save as ols
    from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
    from aec_tpu_torch.utils.weights import load_npz
    from benchmarks.scenes import erle_tail

    cpu_net = load_npz("checkpoints/little_net_robust.npz", device="cpu")
    for n_blocks, hop in GEOMETRIES:
        n = N // hop * hop
        scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
        erb_np = erb_filterbank(n_freqs=scfg.n_freqs)
        erb = torch.as_tensor(erb_np, device=dev)
        kc, nc = KalmanConfig(n_blocks=n_blocks), NlmsConfig(n_blocks=n_blocks)
        far = torch.from_numpy(np.ascontiguousarray(s_far[:, :n])).to(dev)
        mic = torch.from_numpy(np.ascontiguousarray(s_mic[:, :n])).to(dev)
        bar = STAGE1_TOL * float(mic.abs().max())
        tag = f"L = {n_blocks}, block {hop}"
        errs = {}
        stepped = (kalman_cancel_fused_batched, kalman_filter_fused_batched,
                   nlms_cancel_fused_batched, kalman_cancel_fused, nlms_cancel_fused)
        steps_before = [dict(fn.steps) for fn in stepped]
        with torch.no_grad():
            for name, fused, plain, c in (("K1", kalman_cancel_fused_batched, kalman_cancel_plain,
                                           kc),
                                          ("K5", nlms_cancel_fused_batched, nlms_cancel_plain, nc)):
                got, (k,) = drive((fused,), lambda: fused(c, far, mic, block=hop)["wav"])
                check(k == 1 and got.shape == mic.shape and bool(torch.isfinite(got).all()),
                      f"{name} at {tag}")
                errs[name] = float((got - plain(c, far, mic, block=hop)["wav"]).abs().max())
            for name, fused, plain, c in (("K6", kalman_cancel_fused, kalman_cancel_plain, kc),
                                          ("K7", nlms_cancel_fused, nlms_cancel_plain, nc)):
                got, (k,) = drive((fused,), lambda: [fused(c, far[i], mic[i], block=hop)["wav"]
                                                    for i in range(2)])
                check(k == 2, f"{name} at {tag}")
                errs[name] = max(float((g - plain(c, far[i], mic[i], block=hop)["wav"]).abs().max())
                                 for i, g in enumerate(got))
            x_ri = ols.far_end_spectra(far, hop).contiguous()
            d_blocks = mic.reshape(len(names), -1, hop)
            errs["K12"] = float((kalman_filter_fused_batched(kc, x_ri, d_blocks, block=hop)
                                 - kalman_filter_fused_batched_plain(kc, x_ri, d_blocks,
                                                                     block=hop)).abs().max())
            steps = [{k: v - was[k] for k, v in fn.steps.items()} for fn, was in zip(
                stepped, steps_before)]
            phase("geometry", f"{tag}: 8 scenes x {n}: max|d| vs plain " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items()) + f" (bar {bar:.3e}); steps " + ", ".join(
                f"{k} {st}" for k, st in zip(("K1", "K12", "K5", "K6", "K7"), steps)))
            check(max(errs.values()) <= bar, f"a stage-1 kernel disagrees at {tag}")
            check(steps == [{"fft": c, "dense": 0} for c in (1, 1, 1, 2, 2)],
                  f"K1, K12, K5, K6 or K7 did not run the FFT step at {tag}")

            lin_b = kalman_cancel_plain(kc, far, mic, block=hop)["wav"].reshape(len(names), -1, hop)
            far_b = far.reshape(len(names), -1, hop)
            tr_before = dict(little_net_apply_fused.transforms)
            o_k, m_k = little_net_apply_fused(net, lin_b, far_b, erb, scfg)
            o_p, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb, scfg)
            check(little_net_apply_fused.transforms["fft"] == tr_before["fft"] + 1,
                  f"K2 did not run its FFT phases at {tag}")
            k2 = (float((o_k - o_p).abs().max()), float((m_k - m_p).abs().max()))
            k2_bar = (K2_WAV_TOL * float(o_p.abs().max()), K2_MASK_TOL)
            # K4 against the plain composition (and, where that is itself
            # off its fp64 evaluation by more than the bar, against fp64),
            # and stage 2 against K2's plain recurrence on K4's own
            # linear_wav at K2's bars
            hops_before = [dict(fn.steps) for fn in (two_stage_fused, serving_step_fused)]
            f_k = two_stage_fused(net, far, mic, erb, kcfg=kc, scfg=scfg)
            r = k4_against_fp64(net, far, mic, erb, kc, scfg, f_k)
            k4_bar = (bar, K4_WAV_TOL * r["scale"], K4_MASK_TOL)
            o_p4, m_p4 = little_net_apply_fused_plain(
                net, f_k["linear_wav"].reshape(len(names), -1, hop), far_b, erb, scfg)
            k4_s2 = (float((f_k["wav"] - o_p4.reshape(len(names), -1)).abs().max()),
                     float((f_k["mask"] - m_p4).abs().max()))
            k4_s2_bar = (K2_WAV_TOL * float(o_p4.abs().max()), K2_MASK_TOL)
            phase("geometry", f"{tag}: K2 wav {k2[0]:.3e} (bar {k2_bar[0]:.3e}), mask {k2[1]:.3e} "
                  f"(bar {k2_bar[1]:g}); K4's stage 2 vs K2's plain version on its linear_wav: "
                  f"wav {k4_s2[0]:.3e} (bar {k4_s2_bar[0]:.3e}), mask {k4_s2[1]:.3e} (bar "
                  f"{k4_s2_bar[1]:g})")
            phase("geometry", f"{tag}: {k4_report(r, k4_bar, names)}")
            check(all(e <= b for e, b in zip(k2, k2_bar)), f"K2 disagrees at {tag}")
            check(k4_composition_ok(r, "K4", k4_bar), f"K4 disagrees with plain at {tag}")
            check(not k4_composition_ok(r, "tf32", k4_bar),
                  f"the TF32 control passes the K4 check at {tag}")
            check(all(e <= b for e, b in zip(k4_s2, k4_s2_bar)),
                  f"K4's stage 2 disagrees with K2's plain version at {tag}")
            for stage1 in ("kalman", "nlms"):
                ks, ps, rel, _ = serve_pair(net, erb, far, mic, [1] * 40 + [4] * 4, hop=hop,
                                            stage1=stage1, kcfg=kc if stage1 == "kalman" else nc,
                                            scfg=scfg)
                leaf, leaf_rel = state_err(ks, ps)
                phase("geometry", f"{tag}: K3-{stage1} 8 streams, 40 x k=1 + 4 x k=4: out "
                      f"{rel:.3e}, worst state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g})")
                check(rel <= K3_TOL and leaf_rel <= K3_TOL, f"K3-{stage1} disagrees at {tag}")
            hops = [{k: v - was[k] for k, v in fn.steps.items()} for fn, was in zip(
                (two_stage_fused, serving_step_fused), hops_before)]
            phase("geometry", f"{tag}: hops K4 {hops[0]}, K3 {hops[1]}")
            check(hops == [{"fft": 1, "dense": 0}, {"fft": 88, "dense": 0}],
                  f"K3 / K4 did not run their FFT hops at {tag}")

            routes = {
                "batch K1 + K2": ((kalman_cancel_fused_batched, little_net_apply_fused),
                                  lambda: two_stage_cancel(net, far, mic, erb, lin_cfg=kc,
                                                           scfg=scfg)),
                "fast K4": ((two_stage_fused,),
                            lambda: two_stage_cancel(net, far, mic, erb, lin_cfg=kc, scfg=scfg,
                                                     quality="fast")),
                "one by one K6 + K2": ((kalman_cancel_fused, little_net_apply_fused),
                                       lambda: {"wav": torch.stack([two_stage_cancel(
                                           net, far[i], mic[i], erb, lin_cfg=kc,
                                           scfg=scfg)["wav"] for i in range(len(names))])}),
            }
            want = two_stage_cancel(cpu_net, far.cpu(), mic.cpu(), erb_np, lin_cfg=kc,
                                    scfg=scfg)["wav"].numpy()
            for route, (kernels, fn) in routes.items():
                out, counts = drive(kernels, fn)
                check(min(counts) > 0, f"two_stage_cancel's {route} route at {tag} missed a kernel")
                wav = out["wav"].cpu().numpy()
                worst = max(abs(erle_tail(s_mic[i, :n], wav[i]) - erle_tail(s_mic[i, :n], want[i]))
                            for i in range(len(names)))
                phase("geometry", f"{tag}: two_stage_cancel {route}: launches {counts}; worst "
                      f"|kernel - plain| tail ERLE {worst:.4f} dB (bar {ERLE_TOL_DB} dB) [{smi}]")
                check(worst <= ERLE_TOL_DB, f"the {route} route disagrees at {tag}")


def dense_step_phase(dev, net, s_far, s_mic) -> None:
    """21a. K1, K12, K5, K6, K7, K2, K4 and K3 (both filters) at a block with
    a prime factor other than 2, 3 and 5 (224 = 2^5 7, L = 4) on the 8
    scenes (K6, K7 on two of them): the wrappers take their dense step /
    route / transforms / hop there, which must agree with the plain
    versions as the FFT ones do."""
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
    )
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.serving import serving_step_fused
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
    from aec_tpu_torch.linear import overlap_save as ols

    block, cfg, ncfg = 224, KalmanConfig(n_blocks=4), NlmsConfig(n_blocks=4)
    n = N // block * block
    far = torch.from_numpy(np.ascontiguousarray(s_far[:, :n])).to(dev)
    mic = torch.from_numpy(np.ascontiguousarray(s_mic[:, :n])).to(dev)
    x_ri = ols.far_end_spectra(far, block).contiguous()
    d_blocks = mic.reshape(len(s_far), -1, block)
    fns = (kalman_cancel_fused_batched, kalman_filter_fused_batched, nlms_cancel_fused_batched,
           kalman_cancel_fused, nlms_cancel_fused)
    before = [dict(fn.steps) for fn in fns]
    with torch.no_grad():
        got = (kalman_cancel_fused_batched(cfg, far, mic, block=block)["wav"],
               kalman_filter_fused_batched(cfg, x_ri, d_blocks, block=block),
               nlms_cancel_fused_batched(ncfg, far, mic, block=block)["wav"],
               torch.stack([kalman_cancel_fused(cfg, far[i], mic[i], block=block)["wav"]
                            for i in range(2)]),
               torch.stack([nlms_cancel_fused(ncfg, far[i], mic[i], block=block)["wav"]
                            for i in range(2)]))
        torch.cuda.synchronize()
        want = (kalman_cancel_plain(cfg, far, mic, block=block)["wav"],
                kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks, block=block),
                nlms_cancel_plain(ncfg, far, mic, block=block)["wav"])
        want = (*want, want[0][:2], want[2][:2])
    steps = [{k: v - was[k] for k, v in fn.steps.items()} for fn, was in zip(fns, before)]
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    bar = STAGE1_TOL * float(mic.abs().max())
    names = ("K1", "K12", "K5", "K6", "K7")
    phase("geometry", f"L = 4, block {block}: " + ", ".join(
        f"{k} {e:.3e}" for k, e in zip(names, errs)) + f" vs plain (bar {bar:.3e}); steps "
        + ", ".join(f"{k} {st}" for k, st in zip(names, steps)))
    check(steps == [{"fft": 0, "dense": c} for c in (1, 1, 1, 2, 2)],
          "K1, K12, K5, K6 or K7 did not take the dense step at block 224")
    check(max(errs) <= bar, "the dense step disagrees with the plain loops at block 224")

    scfg = StftConfig(2 * block, block, 2 * block)
    erb = torch.as_tensor(erb_filterbank(n_freqs=scfg.n_freqs), device=dev)
    lin_b, far_b = want[0].reshape(len(s_far), -1, block), far.reshape(len(s_far), -1, block)
    before = dict(little_net_apply_fused.transforms)
    with torch.no_grad():
        o_k, m_k = little_net_apply_fused(net, lin_b, far_b, erb, scfg)
        o_p, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb, scfg)
    ran = {k: v - before[k] for k, v in little_net_apply_fused.transforms.items()}
    k2 = (float((o_k - o_p).abs().max()), float((m_k - m_p).abs().max()))
    k2_bar = (K2_WAV_TOL * float(o_p.abs().max()), K2_MASK_TOL)
    phase("geometry", f"block {block}: K2 wav {k2[0]:.3e} (bar {k2_bar[0]:.3e}), mask {k2[1]:.3e} "
          f"(bar {k2_bar[1]:g}) vs plain; transforms {ran}")
    check(ran == {"fft": 0, "dense": 1}, "K2 did not take its dense transforms at block 224")
    check(all(e <= b for e, b in zip(k2, k2_bar)), "K2's dense transforms disagree at block 224")

    before = [dict(fn.steps) for fn in (two_stage_fused, serving_step_fused)]
    with torch.no_grad():
        f_k = two_stage_fused(net, far, mic, erb, kcfg=cfg, scfg=scfg)
        f_p = two_stage_fused_plain(net, far, mic, erb, kcfg=cfg, scfg=scfg)
        k4 = [float((f_k[key] - f_p[key]).abs().max()) for key in ("linear_wav", "wav", "mask")]
        k4_bar = (bar, K4_WAV_TOL * float(f_p["wav"].abs().max()), K4_MASK_TOL)
        k3 = {}
        for stage1, c in (("kalman", cfg), ("nlms", NlmsConfig(n_blocks=4))):
            ks, ps, rel, _ = serve_pair(net, erb, far, mic, [1] * 10 + [4] * 3, hop=block,
                                        stage1=stage1, kcfg=c, scfg=scfg, normalize=True,
                                        gain_norm=True)
            k3[stage1] = (rel, *state_err(ks, ps))
    hops = [{k: v - was[k] for k, v in fn.steps.items()} for fn, was in zip(
        (two_stage_fused, serving_step_fused), before)]
    phase("geometry", f"L = 4, block {block}: K4 " + ", ".join(
        f"{key} {e:.3e} (bar {b:.3e})"
        for key, e, b in zip(("linear_wav", "wav", "mask"), k4, k4_bar))
        + "; " + "; ".join(f"K3-{k} out {v[0]:.3e}, worst state leaf {v[1]} {v[2]:.3e}"
                           for k, v in k3.items()) + f" (bar {K3_TOL:g}); hops K4 {hops[0]}, K3 "
        f"{hops[1]}")
    check(hops == [{"fft": 0, "dense": 1}, {"fft": 0, "dense": 26}],
          "K3 / K4 did not take their dense hops at block 224")
    check(all(e <= b for e, b in zip(k4, k4_bar)), "K4's dense hop disagrees at block 224")
    check(all(v[0] <= K3_TOL and v[2] <= K3_TOL for v in k3.values()),
          "K3's dense hop disagrees at block 224")


def largest_l(run) -> tuple[int, str]:
    """The largest partition count ``run(L)`` accepts, raising L from 1 until
    it refuses; the refusal must be for shared memory. -> (L, the refusal)."""
    for n_blocks in range(1, 257):
        try:
            run(n_blocks)
        except ValueError as e:
            check("shared memory" in str(e) and n_blocks > 1,
                  f"a refusal at L = {n_blocks} that is not for shared memory: {e}")
            return n_blocks - 1, str(e)
    raise SystemExit("chip_smoke: FAILED: no partition count up to 256 was refused")


def limits_phase(dev, net, seed: int, smi: str) -> None:
    """21b. Each kernel whose shared-memory layout grows with the partition
    count, at the largest L its wrapper accepts at blocks 256 and 160 (two
    full register chunks of partitions and more), against its plain version
    at the geometry phase's bars; one partition more must be refused."""
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
    )
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
    from aec_tpu_torch.linear import overlap_save as ols

    for hop in (256, 160):
        scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
        erb = torch.as_tensor(erb_filterbank(n_freqs=scfg.n_freqs), device=dev)
        far, mic = make_batch(dev, seed + 30, 2, 200 * hop)
        tiny = far[:, :2 * hop].contiguous(), mic[:, :2 * hop].contiguous()
        bar = STAGE1_TOL * float(mic.abs().max())

        def stage1(fn, cfg, one):
            def run(n_blocks, f, m):
                if one:
                    f, m = f[0].contiguous(), m[0].contiguous()
                return {"wav": fn(cfg(n_blocks=n_blocks), f, m, block=hop)["wav"]}
            return run

        def spectra(fn):
            return lambda n_blocks, f, m: {"wav": fn(
                KalmanConfig(n_blocks=n_blocks), ols.far_end_spectra(f, hop).contiguous(),
                m.reshape(2, -1, hop).contiguous(), block=hop)}

        def fast(fn):
            return lambda n_blocks, f, m: fn(net, f, m, erb, kcfg=KalmanConfig(n_blocks=n_blocks),
                                             scfg=scfg)

        def serve(stage1_, cfg):
            def run(n_blocks, f, m):
                st = serving_init(2, kcfg=cfg(n_blocks=n_blocks), scfg=scfg, stage1=stage1_,
                                  device=dev)
                return serving_step_fused(net, st, f[:, :hop].contiguous(), m[:, :hop].contiguous(),
                                          erb, cfg(n_blocks=n_blocks), scfg, stage1=stage1_)
            return run

        def k4_bars(want):
            return {"linear_wav": bar, "wav": K4_WAV_TOL * float(want["wav"].abs().max()),
                    "mask": K4_MASK_TOL}

        cases = {  # name: (kernel route, plain route or None for K3, bars from plain's output)
            "K1": (stage1(kalman_cancel_fused_batched, KalmanConfig, False),
                   stage1(kalman_cancel_plain, KalmanConfig, False), None),
            "K12": (spectra(kalman_filter_fused_batched), spectra(kalman_filter_fused_batched_plain),
                    None),
            "K5": (stage1(nlms_cancel_fused_batched, NlmsConfig, False),
                   stage1(nlms_cancel_plain, NlmsConfig, False), None),
            "K6": (stage1(kalman_cancel_fused, KalmanConfig, True),
                   stage1(kalman_cancel_plain, KalmanConfig, True), None),
            "K7": (stage1(nlms_cancel_fused, NlmsConfig, True),
                   stage1(nlms_cancel_plain, NlmsConfig, True), None),
            "K4": (fast(two_stage_fused), fast(two_stage_fused_plain), k4_bars),
            "K3-kalman": (serve("kalman", KalmanConfig), None, None),
            "K3-nlms": (serve("nlms", NlmsConfig), None, None),
        }
        with torch.no_grad():
            for name, (run, plain, bars) in cases.items():
                n_max, refusal = largest_l(lambda n_blocks: run(n_blocks, *tiny))
                floor = LARGEST_L.get(name)  # the FFT layouts keep the dense ones' L
                if floor:
                    check(n_max >= floor[hop != 256],
                          f"{name} takes fewer partitions at block {hop} than before ({n_max})")
                if plain is None:
                    stage1_ = name.split("-")[1]
                    cfg = (KalmanConfig if stage1_ == "kalman" else NlmsConfig)(n_blocks=n_max)
                    ks, ps, rel, _ = serve_pair(net, erb, far, mic, [1] * 40 + [4] * 4, hop=hop,
                                                stage1=stage1_, kcfg=cfg, scfg=scfg)
                    leaf, leaf_rel = state_err(ks, ps)
                    errs = {"out / scale": (rel, K3_TOL), f"state {leaf} / scale": (leaf_rel, K3_TOL)}
                else:
                    got, want = run(n_max, far, mic), plain(n_max, far, mic)
                    b = bars(want) if bars else {"wav": bar}
                    errs = {k: (float((got[k] - want[k]).abs().max()), b[k]) for k in b}
                torch.cuda.synchronize()
                phase("limits", f"{name} block {hop}: largest L {n_max}, max|d| vs plain " + ", ".join(
                    f"{k} {e:.3e} (bar {v:.3e})" for k, (e, v) in errs.items())
                    + f"; L {n_max + 1} refused: {refusal}")
                check(all(e <= v for e, v in errs.values()),
                      f"{name} disagrees with its plain version at its largest L ({n_max}, block {hop})")


def k2_against_fp64(net, lin_b, far_b, erb) -> dict:
    """K2's mask, the plain fp32 version's and the plain version's with TF32
    products (the lower-precision control), each as max|d| from the plain
    version evaluated in fp64 on the same fp32 inputs and weights."""
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain

    _, m_64 = little_net_apply_fused_plain(copy.deepcopy(net).double(), lin_b.double(),
                                           far_b.double(), erb.double())
    _, m_k = little_net_apply_fused(net, lin_b, far_b, erb)
    _, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, m_t = little_net_apply_fused_plain(net, lin_b, far_b, erb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    return {"K2": float((m_k.double() - m_64).abs().max()),
            "plain": float((m_p.double() - m_64).abs().max()),
            "tf32": float((m_t.double() - m_64).abs().max()),
            "K2 - plain": float((m_k - m_p).abs().max())}


def k2_roundoff_phase(dev, seed: int) -> None:
    """4b. K2's mask on full-scale noise (8 x 40 blocks, far end at unit
    variance, Kalman residual as stage 2's input) through four untrained
    nets, against the fp64 evaluation and the plain version, where the
    mask's round-off is largest; the plain fp32 version and TF32 products
    (the lower-precision control) beside it."""
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.kernels.kalman import kalman_cancel_plain
    from aec_tpu_torch.models.little_net import little_net_init

    erb = torch.as_tensor(erb_filterbank(), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 40 * HOP
    with torch.no_grad():
        for s in range(1, 5):
            rnet = little_net_init(generator=torch.Generator().manual_seed(seed + s), device=dev)
            far = torch.randn(8, n, generator=g, device=dev)
            rir = torch.randn(8, 300, generator=g, device=dev)
            rir = 0.3 * rir * torch.exp(-torch.arange(300, device=dev) / 60.0)
            echo = torch.fft.irfft(torch.fft.rfft(far, n + 300) * torch.fft.rfft(rir, n + 300),
                                   n + 300)[:, :n]
            mic = echo + 0.01 * torch.randn(8, n, generator=g, device=dev)
            lin = kalman_cancel_plain(KalmanConfig(), far, mic)["wav"]
            r = k2_against_fp64(rnet, lin.reshape(8, -1, HOP), far.reshape(8, -1, HOP), erb)
            phase("K2 round-off", f"untrained net {seed + s}, full-scale noise: mask max|d| from "
                  f"fp64: K2 {r['K2']:.3e}, plain fp32 {r['plain']:.3e}, TF32 products "
                  f"{r['tf32']:.3e} (control, >= {K2_CONTROL_MIN:g}); K2 - plain "
                  f"{r['K2 - plain']:.3e} (bar {K2_LOUD_MASK_TOL:g} for K2 - fp64 and K2 - plain)")
            check(max(r["K2"], r["K2 - plain"]) <= K2_LOUD_MASK_TOL,
                  "K2's mask is off its fp64 evaluation or its plain version")
            check(r["tf32"] >= K2_CONTROL_MIN, "the TF32 control sits within the mask bar")


def k4_against_fp64(net, far, mic, erb, kc, scfg, f_k) -> dict:
    """Per utterance, the max|d| of each of K4's outputs ``f_k`` and of the
    plain composition's with TF32 products (the control) from the plain
    fp32 composition and from its fp64 evaluation on the same fp32 inputs
    and weights, and the plain fp32 composition's from fp64: {"K4": ...,
    "tf32": ...}, each {"plain": ..., "fp64": ...}, and {"plain": {"fp64":
    ...}}, each {output: (B,) float64}; and the plain composition's wav
    scale."""
    from aec_tpu_torch.kernels.two_stage import two_stage_fused_plain

    kw = {"kcfg": kc, "scfg": scfg}
    f_64 = two_stage_fused_plain(copy.deepcopy(net).double(), far.double(), mic.double(),
                                 erb.double(), **kw)
    f_p = two_stage_fused_plain(net, far, mic, erb, **kw)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f_t = two_stage_fused_plain(net, far, mic, erb, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    def d(a, b):
        return {key: (a[key].double() - b[key].double()).abs().flatten(1).amax(1)
                for key in ("linear_wav", "wav", "mask")}

    return {"K4": {"plain": d(f_k, f_p), "fp64": d(f_k, f_64)},
            "tf32": {"plain": d(f_t, f_p), "fp64": d(f_t, f_64)},
            "plain": {"fp64": d(f_p, f_64)}, "scale": float(f_p["wav"].abs().max())}


def k4_composition_ok(r: dict, name: str, bars: tuple) -> bool:
    """Whether evaluation ``name`` of :func:`k4_against_fp64`'s readings
    ``r`` passes: per utterance and output, within the bar of the plain fp32
    composition, or, where that lies farther than the bar from fp64,
    within ``K4_ILL_RATIO`` times its distance of fp64."""
    plain = r["plain"]["fp64"]
    return all(bool(torch.where(plain[key] > bar, r[name]["fp64"][key] <= K4_ILL_RATIO * plain[key],
                                r[name]["plain"][key] <= bar).all())
               for key, bar in zip(("linear_wav", "wav", "mask"), bars))


def k4_report(r: dict, bars: tuple, names) -> str:
    """K4's and the control's worst distances, and the utterances where the
    plain fp32 composition lies farther than the bar from fp64."""
    keys = ("linear_wav", "wav", "mask")
    ill = [f"{names[i]} {key}: plain {float(r['plain']['fp64'][key][i]):.3e}, K4 "
           f"{float(r['K4']['fp64'][key][i]):.3e}"
           for key, bar in zip(keys, bars) for i in range(len(names))
           if float(r["plain"]["fp64"][key][i]) > bar]
    return ("K4 vs plain " + ", ".join(f"{key} {float(r['K4']['plain'][key].max()):.3e} (bar "
                                       f"{bar:.3e})" for key, bar in zip(keys, bars))
            + "; from fp64 where plain fp32 lies beyond the bar (K4 bar "
            f"{K4_ILL_RATIO:g} x plain's): {'; '.join(ill) or 'none'}; TF32 control vs plain "
            + ", ".join(f"{key} {float(r['tf32']['plain'][key].max()):.3e}" for key in keys))


def k4_roundoff_phase(dev, net, seed: int) -> None:
    """21b. K4 and the plain composition against its fp64 evaluation on the
    bulk_delay scene at L = 10, block 160, where every fp32 evaluation's
    mask lies farthest from fp64: the scene of three seeds as one batch, K4
    twice (it must repeat bit for bit), at the composition check of the
    geometry phase."""
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.two_stage import two_stage_fused
    from benchmarks.scenes import make_scenes

    hop, kc = 160, KalmanConfig(n_blocks=10)
    n = N // hop * hop
    scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
    erb = torch.as_tensor(erb_filterbank(n_freqs=scfg.n_freqs), device=dev)
    seeds = [seed + i for i in range(3)]
    sc = [make_scenes(np.random.default_rng(s), n=N, kinds=["bulk_delay"])["bulk_delay"]
          for s in seeds]
    far, mic = (torch.from_numpy(np.stack([x[i][:n] for x in sc])).to(dev) for i in range(2))
    with torch.no_grad():
        f_k = two_stage_fused(net, far, mic, erb, kcfg=kc, scfg=scfg)
        again = two_stage_fused(net, far, mic, erb, kcfg=kc, scfg=scfg)
        r = k4_against_fp64(net, far, mic, erb, kc, scfg, f_k)
    bars = (STAGE1_TOL * float(mic.abs().max()), K4_WAV_TOL * r["scale"], K4_MASK_TOL)
    repeat = max(float((f_k[key] - again[key]).abs().max()) for key in f_k)
    for i, s in enumerate(seeds):
        phase("K4 round-off", f"bulk_delay (seed {s}), L = 10, block 160: max|d| from fp64 " +
              ", ".join(f"{key} K4 {float(r['K4']['fp64'][key][i]):.3e} / plain fp32 "
                        f"{float(r['plain']['fp64'][key][i]):.3e} / TF32 "
                        f"{float(r['tf32']['fp64'][key][i]):.3e}"
                        for key in ("linear_wav", "wav", "mask"))
              + f"; K4 vs plain mask {float(r['K4']['plain']['mask'][i]):.3e}")
    phase("K4 round-off", f"K4 run twice: max|d| {repeat:.3e}")
    check(repeat == 0.0, "K4 does not repeat its result")
    check(k4_composition_ok(r, "K4", bars), "K4 is off the plain composition and its fp64 "
          "evaluation on bulk_delay at block 160")
    check(not k4_composition_ok(r, "tf32", bars), "the TF32 control passes the K4 check")


def lstm_phase(dev, seed: int, reps: int, smi: str, costs: list[dict]) -> dict:
    """22. K9 at DccrnConfig()'s width (two groups, I = H = 1024, T = 513)
    at B = 1 and B = 16 (the largest B ``complex_lstm_scan`` routes to it)
    against its plain version; times beside the plain scan and cuDNN's
    nn.LSTM (one call per group over the 2B rows with K9's weights; it also
    does the input projection K9 leaves to a matmul); then ``costs``' K9
    rows (kernels/lstm_costs.py): the time per step, whole and with the dots
    cut out, where the weights lie, ptxas's registers and spills."""
    from aec_tpu_torch.kernels.lstm import (
        grouped_lstm_recurrence,
        grouped_lstm_recurrence_plain,
        grouped_projection,
        stacked,
    )
    from aec_tpu_torch.kernels.lstm_costs import report
    from aec_tpu_torch.ops.lstm import complex_lstm_init

    g = torch.Generator().manual_seed(seed)
    out = {"err": 0.0, "shapes": {}}
    for b in (1, 16):
        params = complex_lstm_init(2048, 2048, generator=g, device=dev)
        r, i = (torch.randn(b, T_DCCRN, 1024, generator=g).to(dev) for _ in range(2))
        x2 = torch.cat([r, i], 0)
        lstms = []
        for grp in ("real", "imag"):
            lstm = torch.nn.LSTM(1024, 1024, batch_first=True).to(dev)
            with torch.no_grad():
                for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                                  ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    getattr(lstm, name).copy_(params[grp][key])
            lstms.append(lstm)
        with torch.no_grad():
            xp = grouped_projection(params, x2).contiguous()
            w = stacked(params, "w_hh")
            ys = grouped_lstm_recurrence(xp, w)
            want = grouped_lstm_recurrence_plain(xp, w)
            lib = torch.stack([m(x2)[0] for m in lstms])
            torch.cuda.synchronize()
            check(ys.shape == (2, 2 * b, T_DCCRN, 1024) and bool(torch.isfinite(ys).all()),
                  "K9 output")
            err = float((ys - want).abs().max())
            lib_err = float((lib - want).abs().max())
            t_k = time_ms(lambda: grouped_lstm_recurrence(xp, w), reps)
            t_p = time_ms(lambda: grouped_lstm_recurrence_plain(xp, w), reps)
            t_lib = time_ms(lambda: [m(x2) for m in lstms], reps)
        phase("K9 vs plain", f"B = {b}, T = {T_DCCRN}, H = 1024, 2 groups: max|d| = {err:.3e} "
              f"(bar {K9_TOL:g}); cuDNN nn.LSTM vs plain {lib_err:.3e} (information)")
        check(err <= K9_TOL, "K9 disagrees with its plain version")
        phase("time", f"K9 B = {b}, T = {T_DCCRN}: {t_k:.3f} ms = {t_k / T_DCCRN * 1e3:.2f} us a "
              f"step (plain {t_p:.2f} ms, cuDNN nn.LSTM x 2 groups {t_lib:.3f} ms) [{smi}]")
        out["err"] = max(out["err"], err)
        out["shapes"][b] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_lib}
        del params, xp, w, ys, want, lib, lstms
    for row in costs:
        if row["kernel"] == "K9":
            phase("K9 step", f"{report(row)} [{smi}]")
    return out


def k9b_split(rows: list[dict], path: str, smi: str) -> dict:
    """Phase 22 / 24's line of ``kernels/lstm_bwd_costs.py`` for ``path``:
    this run's µs a step, whole and cut, beside 143f1cb's (K9B_PARENT_US);
    -> this run's µs a step by variant."""
    from aec_tpu_torch.kernels.lstm_bwd_costs import report

    row = next(r for r in rows if r["path"] == path)
    parent = K9B_PARENT_US[path]
    phase("K9b split", f"{report(row)}; 143f1cb's design: " + ", ".join(
        f"{v} {us:.2f} us" for v, us in parent.items()) + f" [{smi}]")
    check(all(math.isfinite(v) and v > 0 for v in row["us_per_step"].values()),
          f"K9b's split at {path}")
    return row["us_per_step"]


def lstm_train_phase(dev, seed: int, reps: int, smi: str, bwd_costs: list[dict]) -> dict:
    """22, training: K9 and K9b at DCCRN's training shape (B = 16 x 8 s:
    two groups of 32 rows, T = 501, I = H = 1024): K9's ys with and without
    saving the gates, bit for bit; K9b against its plain version on those
    gates (1e-5 of dxp's scale); the route's gradients into both inputs and
    the 8 parameters (``complex_lstm_scan``: K9 saving, K9b, the products)
    against the plain route's (the grouped loop differentiated by autograd)
    at K8's gradient bar of each leaf's scale, with both routes' launches and
    the plain loops the route entered (none); then in turns, each four
    times: cuDNN's nn.LSTM forward and backward (one per group over the 2B
    rows with K9's weights, the recombination, the same cotangent), the
    route's; the backwards alone: cuDNN's and the route's of a recorded
    forward, K9b on saved gates; the plain versions once."""
    from aec_tpu_torch.kernels.lstm import (
        grouped_lstm_recurrence,
        grouped_projection,
        recombine,
        stacked,
    )
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward, lstm_backward_plain
    from aec_tpu_torch.ops.lstm import complex_lstm_init, complex_lstm_scan

    b, t, h = 16, N_TRAIN // HOP + 1, 1024
    g = torch.Generator().manual_seed(seed + 3)
    params = complex_lstm_init(2 * h, 2 * h, generator=g, device=dev)
    r, i = (torch.randn(b, t, h, generator=g).to(dev) for _ in range(2))
    cot = [torch.randn(b, t, h, generator=g).to(dev) for _ in range(2)]
    with torch.no_grad():
        xp = grouped_projection(params, torch.cat([r, i], 0)).contiguous()
        w = stacked(params, "w_hh")
        ys = grouped_lstm_recurrence(xp, w)
        ys_s, saved = grouped_lstm_recurrence(xp, w, save=True)
        g_ys = torch.randn(2, 2 * b, t, 1, h, generator=g).to(dev)
        saved5 = saved.unsqueeze(3)
        got = lstm_backward(g_ys, saved5, w)
        torch.cuda.synchronize()
        want = lstm_backward_plain(g_ys, saved5, w)
    same = torch.equal(ys, ys_s)
    k9b_err = float((got - want).abs().max())
    k9b_rel = k9b_err / float(want.abs().max())
    del ys, ys_s, got, want, xp

    leaves = {(grp, k): v.detach().clone().requires_grad_()
              for grp, sub in params.items() for k, v in sub.items()}
    tree = {grp: {k: leaves[grp, k] for k in sub} for grp, sub in params.items()}
    rl, il = r.detach().clone().requires_grad_(), i.detach().clone().requires_grad_()
    order = [rl, il, *leaves.values()]

    def fwd_bwd(fused=None):
        return torch.autograd.grad(complex_lstm_scan(tree, rl, il, fused=fused), order, cot)

    grads, counts, entered = {}, {}, {}
    for fused in (None, False):
        with plain_entries() as n:
            grads[fused], counts[fused] = drive((grouped_lstm_recurrence, lstm_backward),
                                                lambda: fwd_bwd(fused))
        entered[fused] = n[0]
    route_rel = max(float((a - w_).abs().max() / w_.abs().max())
                    for a, w_ in zip(grads[None], grads[False]))
    del grads
    phase("K9b vs plain", f"B = {b}, T = {t}, H = {h}, 2 groups: K9's ys with and without "
          f"saving the gates bit-equal {same}; K9b vs its plain version max|d| / scale "
          f"{k9b_rel:.3e} (bar {K9_TOL:g}); the route's gradients vs the plain route's, worst "
          f"leaf {route_rel:.3e} (bar {K8_GRAD_TOL:g}); launches K9 / K9b: route {counts[None]}, "
          f"plain route {counts[False]}; plain loops entered by the route {entered[None]}")
    check(same, "K9's ys change with the save flag")
    check(k9b_rel <= K9_TOL, "K9b disagrees with its plain version")
    check(counts[None] == [1, 1] and counts[False] == [0, 0] and entered[None] == 0,
          "complex_lstm_scan did not route to K9 and K9b at this batch")
    check(route_rel <= K8_GRAD_TOL, "the route's gradients disagree with the plain route's")

    lstms = []
    for grp in ("real", "imag"):
        lstm = torch.nn.LSTM(h, h, batch_first=True).to(dev)
        with torch.no_grad():
            for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                              ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                getattr(lstm, name).copy_(params[grp][key])
        lstms.append(lstm)
    lib_leaves = [rl, il, *(p_ for m in lstms for p_ in m.parameters())]

    def lib_out():
        return recombine(torch.stack([m(torch.cat([rl, il], 0))[0] for m in lstms]), b)

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_out(), lib_leaves, cot)

    pairs = in_turns([lib_fwd_bwd, fwd_bwd], reps)
    out_lib, out_route = lib_out(), complex_lstm_scan(tree, rl, il)
    bwd = (lambda: torch.autograd.grad(out_lib, lib_leaves, cot, retain_graph=True),
           lambda: torch.autograd.grad(out_route, order, cot, retain_graph=True),
           lambda: lstm_backward(g_ys, saved5, w))
    bpairs = in_turns(list(bwd), reps)
    del out_lib, out_route
    t_pb = time_once(lambda: lstm_backward_plain(g_ys, saved5, w))
    t_plain = time_once(lambda: fwd_bwd(False))
    med = [statistics.median(p_) for p_ in pairs]
    bmed = [statistics.median(p_) for p_ in bpairs]
    fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)  # noqa: E731
    k9b_b = k9b_bound(2 * 2 * b, t, h)
    phase("time", f"DCCRN's LSTM layer, B = {b}, T = {t}, in turns (4 each, ms): forward and "
          f"backward cuDNN nn.LSTM x 2 groups {fmt(pairs[0])}, the route (K9 + K9b + products) "
          f"{fmt(pairs[1])}, ratio {med[1] / med[0]:.3f}; the backwards alone: cuDNN "
          f"{fmt(bpairs[0])}, the route's {fmt(bpairs[1])}, K9b {fmt(bpairs[2])} (plain "
          f"{t_pb:.1f}; bound {k9b_b['bound_ms']:.3f} ms, {k9b_b['bound_by']}); the plain "
          f"route's forward and backward {t_plain:.1f} ms [{smi}]")
    split = k9b_split(bwd_costs, "dccrn", smi)
    return {"k9b_split_us": {"dccrn": split}, "k9b_err": k9b_err, "k9b_ms": bmed[2],
            "k9b_plain_ms": t_pb, "k9b_bound": k9b_b,
            "route_bwd_ms": bmed[1], "lib_bwd_ms": bmed[0], "route_fwd_bwd_ms": med[1],
            "lib_fwd_bwd_ms": med[0], "plain_fwd_bwd_ms": t_plain}


def dccrn_phase(dev, names, s_far, s_mic, reps: int, smi: str) -> dict:
    """23. cli/infer's DCCRN enhancer: DccrnConfig() from dccrn_init (seed
    0), saved with train/checkpoints.save under {params, model_state} and
    restored by _make_enhancer("dccrn", path, "kalman"), on the 8 scenes one
    by one (batch 1, as cli/infer's loader gives them). The kernel route
    runs K1 once and K9 twice (one launch per complex-LSTM layer) per
    utterance; its plain version is the same path with Kalman's plain loop
    and the plain complex-LSTM scan, on the card. The call is timed with
    W_hh packed (warm) and once packing it first (cold), beside K9's device
    time in a call (torch.profiler)."""
    from aec_tpu_torch.cli.infer import _make_enhancer, _tree_to
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.kernels.lstm import clear_cache as clear_k9
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.kernels.serving_costs import kernel_ms
    from aec_tpu_torch.models.dccrn import DccrnConfig, dccrn_apply, dccrn_init
    from aec_tpu_torch.train import checkpoints

    params, state = dccrn_init(generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dccrn.npz")
        checkpoints.save(path, {"params": params, "model_state": state})
        enhance, params = _make_enhancer("dccrn", path, "kalman", StftConfig(), device=dev)
    state = _tree_to(state, dev)
    sf, sm = (torch.from_numpy(a).to(dev) for a in (s_far, s_mic))

    def kernel_route():
        return [enhance(sf[i:i + 1], sm[i:i + 1]) for i in range(len(names))]

    def plain_route(i):
        lin = kalman_cancel_plain(KalmanConfig(), sf[i:i + 1], sm[i:i + 1])["wav"]
        out, _ = dccrn_apply(params, state, lin, sf[i:i + 1], DccrnConfig(), lstm_fused=False)
        return out["wav"]

    got, (k1, k9) = drive((kalman_cancel_fused_batched, grouped_lstm_recurrence), kernel_route)
    phase("dccrn path", f"cli/infer DCCRN enhancer, 8 scenes x {N} one by one: launches K1 {k1}, "
          f"K9 {k9} (cuDNN TF32 {torch.backends.cudnn.allow_tf32})")
    check(k1 == len(names) and k9 == 2 * len(names),
          "the DCCRN path did not run K1 + K9 per utterance")
    worst = 0.0
    with torch.no_grad():
        for i in range(len(names)):
            want = plain_route(i)
            check(got[i].shape == (1, N) and bool(torch.isfinite(got[i]).all()), "DCCRN wav")
            worst = max(worst, float((got[i] - want).abs().max()) / float(want.abs().max()))
        t_utt = time_ms(lambda: enhance(sf[:1], sm[:1]), reps)
        t_cold = time_once(lambda: (clear_k9(), enhance(sf[:1], sm[:1])))
        t_k9 = kernel_ms(lambda: enhance(sf[:1], sm[:1]), reps, "lstm_kernel")
        t_plain = time_ms(lambda: plain_route(0), max(1, reps // 2))
    phase("dccrn path", f"kernel vs plain route: worst max|d| / scale = {worst:.3e} (bar "
          f"{DCCRN_WAV_TOL:g}); {t_utt:.2f} ms per 8.2 s utterance = "
          f"{N / SR / (t_utt / 1e3):.1f} x realtime (plain route {t_plain:.1f} ms) [{smi}]")
    phase("dccrn path", f"the call with W_hh packed (warm) {t_utt:.2f} ms, packing it first "
          f"(cold) {t_cold:.2f} ms; K9's device time in a call {t_k9:.3f} ms (2 launches) [{smi}]")
    check(worst <= DCCRN_WAV_TOL, "the DCCRN kernel route disagrees with its plain route")
    print(f"dccrn_utt_ms={t_utt:.3f}", flush=True)
    return {"k9_launches": k9}


def fullsubnet_phase(dev, names, s_far, s_mic, reps: int, smi: str, costs: list[dict]) -> dict:
    """24. K11 at FullSubNetConfig()'s widths (H_fb 256, H_sb 96, F = 161) over
    T = 820 frames (8.2 s at hop 160) at B = 1 and 4 against its plain joint
    loop, timed beside it and, in turns, beside the library composition of
    the same function: cuDNN's nn.LSTM over the full band from its input
    (fb_in; it also does the input projection K11 leaves to a matmul), the
    embedding, nn.LSTM over the B F bins' rows from [neighbourhood ||
    embedding], K11's weights (K11 runs on the projections of the same
    inputs, and the two outputs are compared for information); ``costs``'
    rows (kernels/fsn_costs.py: the producer alone and the consumers
    alone); cli/infer's FullSubNet enhancer (fullsubnet_init, seed 0, saved
    with train/checkpoints, restored by _make_enhancer("fullsubnet", path,
    "kalman")) on the 8 scenes one by one, K1 + K11 per utterance, against
    the plain route (Kalman's plain loop, the plain joint loop) on the card."""
    from aec_tpu_torch.cli.infer import _make_enhancer
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.fsn_costs import report
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.models.fullsubnet import (
        FullSubNetConfig,
        _joint_scan_hs,
        fullsubnet_apply,
        fullsubnet_init,
    )
    from aec_tpu_torch.train import checkpoints

    cfg = FullSubNetConfig()
    g = torch.Generator().manual_seed(0)
    out = {"err": 0.0, "shapes": {}}
    nb = 2 * (2 * cfg.neighborhood + 1)  # the sub-band input's neighbourhood columns
    for b in (1, 4):
        params = fullsubnet_init(cfg, generator=g, device=dev)
        fb_in = torch.rand(b, T_FSN, cfg.fb_input, generator=g).to(dev)
        sb_nb = torch.rand(b, T_FSN, cfg.n_freqs, nb, generator=g).to(dev)
        fb_p, sb_p = params["fb_lstm"], params["sb_lstm"]
        lstms = {}
        for name, p_, i, h in (("fb", fb_p, cfg.fb_input, cfg.fb_hidden),
                               ("sb", sb_p, cfg.sb_input, cfg.sb_hidden)):
            lstms[name] = torch.nn.LSTM(i, h, batch_first=True).to(dev)
            with torch.no_grad():
                for attr, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                                  ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    getattr(lstms[name], attr).copy_(p_[key])

        def library():
            fb_seq = lstms["fb"](fb_in)[0]
            emb = torch.relu(fb_seq @ params["fb_out"]["w"].T + params["fb_out"]["b"])
            sb_in = torch.cat([sb_nb, emb[..., None]], dim=-1).transpose(1, 2)
            return lstms["sb"](sb_in.reshape(b * cfg.n_freqs, T_FSN, cfg.sb_input))[0]

        with torch.no_grad():
            xp_fb = (fb_in @ fb_p["w_ih"].T + fb_p["b_ih"] + fb_p["b_hh"]).contiguous()
            xp_sb = (sb_nb @ sb_p["w_ih"][:, :nb].T + sb_p["b_ih"] + sb_p["b_hh"]).contiguous()
            ys = joint_recurrence(params, xp_fb, xp_sb)
            want = _joint_scan_hs(params, xp_fb, xp_sb)
            lib = library().reshape(b, cfg.n_freqs, T_FSN, cfg.sb_hidden).transpose(1, 2)
            torch.cuda.synchronize()
            check(ys.shape == (b, T_FSN, cfg.n_freqs, cfg.sb_hidden)
                  and bool(torch.isfinite(ys).all()), "K11 output")
            err = float((ys - want).abs().max())
            lib_err = float((lib - want).abs().max())
            turns = [time_ms(fn, reps) for fn in (
                lambda: joint_recurrence(params, xp_fb, xp_sb), library, library,
                lambda: joint_recurrence(params, xp_fb, xp_sb))]
            t_k, t_lib = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            t_p = time_ms(lambda: _joint_scan_hs(params, xp_fb, xp_sb), 1)
        phase("K11 vs plain", f"B = {b}, T = {T_FSN}, H_fb 256, H_sb 96, F 161: max|d| = "
              f"{err:.3e} (bar {K11_TOL:g}); the library composition vs plain {lib_err:.3e} "
              "(information)")
        check(err <= K11_TOL, "K11 disagrees with its plain version")
        phase("time", f"K11 B = {b}, T = {T_FSN}: {t_k:.3f} ms = {t_k / T_FSN * 1e3:.2f} us a "
              f"frame (plain joint loop {t_p:.2f} ms; in turns K11 {turns[0]:.3f} / "
              f"{turns[3]:.3f}, the library composition (cuDNN nn.LSTM x 2 and the embedding) "
              f"{turns[1]:.3f} / {turns[2]:.3f} ms) [{smi}]")
        out["err"] = max(out["err"], err)
        out["shapes"][b] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_lib}
        del params, fb_in, sb_nb, xp_fb, xp_sb, ys, want, lib, lstms
    for row in costs:
        phase("K11 parts", f"{report(row)} [{smi}]")
        out["shapes"][row["b"]].update(producer_ms=row["ms"]["producer"],
                                       consumers_ms=row["ms"]["consumers"])

    params = fullsubnet_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fullsubnet.npz")
        checkpoints.save(path, {"params": params})
        enhance, params = _make_enhancer("fullsubnet", path, "kalman", StftConfig(), device=dev)
    sf, sm = (torch.from_numpy(a).to(dev) for a in (s_far, s_mic))

    def plain_route(i):
        lin = kalman_cancel_plain(KalmanConfig(), sf[i:i + 1], sm[i:i + 1])["wav"]
        return fullsubnet_apply(params, lin, sf[i:i + 1], cfg, joint_kernel=False)["wav"]

    got, (k1, k11) = drive((kalman_cancel_fused_batched, joint_recurrence),
                           lambda: [enhance(sf[i:i + 1], sm[i:i + 1]) for i in range(len(names))])
    phase("fullsubnet path", f"cli/infer FullSubNet enhancer, 8 scenes x {N} one by one: "
          f"launches K1 {k1}, K11 {k11}")
    check(k1 == len(names) and k11 == len(names),
          "the FullSubNet path did not run K1 + K11 per utterance")
    worst = 0.0
    with torch.no_grad():
        for i in range(len(names)):
            want = plain_route(i)
            check(got[i].shape == want.shape and bool(torch.isfinite(got[i]).all()),
                  "FullSubNet wav")
            worst = max(worst, float((got[i] - want).abs().max()) / float(want.abs().max()))
        t_utt = time_ms(lambda: enhance(sf[:1], sm[:1]), reps)
        t_plain = time_ms(lambda: plain_route(0), 1)
    phase("fullsubnet path", f"kernel vs plain route: worst max|d| / scale = {worst:.3e} (bar "
          f"{ENHANCER_WAV_TOL:g}); {t_utt:.2f} ms per 8.2 s utterance = "
          f"{N / SR / (t_utt / 1e3):.1f} x realtime (plain route {t_plain:.1f} ms) [{smi}]")
    check(worst <= ENHANCER_WAV_TOL, "the FullSubNet kernel route disagrees with its plain route")
    out["launches"] = k11
    return out


def fullsubnet_train_phase(dev, seed: int, reps: int, smi: str, bwd_costs: list[dict]) -> dict:
    """24, training: K11 and K9b at FullSubNetConfig()'s widths and the
    training shape (B = 16 x 8 s, T = 801 frames at hop 160): K11's
    sequence with and without saving what the backward reads, bit for bit;
    K9b against its plain version over the sub band (16 x 161 rows, H = 96)
    and the full band (16 rows, H = 256) on those saved gates (1e-5 of
    dxp's scale); at B = 4 the route's gradients into both projections and
    the 5 weights (``fsn_joint_fused``: K11 saving, K9b twice, the products)
    against the plain joint loop differentiated by autograd (K8's gradient
    bar of each leaf's scale), with the launches and the plain loops the
    route entered (none); then in turns at B = 16, each four times: the
    library composition's forward and backward (cuDNN's nn.LSTM over the
    full band from its input, the embedding, nn.LSTM over the B F bins,
    K11's weights) and the route's from the same inputs (the hoisted
    projections, K11, K9b twice, the products); the backwards alone: the
    library's and the route's of a recorded forward, K9b over each band on
    saved gates; the plain versions once."""
    from aec_tpu_torch.kernels.fullsubnet import _LEAVES, fsn_joint_fused, joint_recurrence
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward, lstm_backward_plain
    from aec_tpu_torch.models.fullsubnet import FullSubNetConfig, _joint_scan_hs, fullsubnet_init

    cfg = FullSubNetConfig()
    b, t, f = 16, N_TRAIN // 160 + 1, cfg.n_freqs
    hf, hs = cfg.fb_hidden, cfg.sb_hidden
    nb = 2 * (2 * cfg.neighborhood + 1)
    g = torch.Generator().manual_seed(seed + 5)
    params = fullsubnet_init(cfg, generator=g, device=dev)
    fb_p, sb_p = params["fb_lstm"], params["sb_lstm"]
    fb_in = torch.rand(b, t, cfg.fb_input, generator=g).to(dev)
    sb_nb = torch.rand(b, t, f, nb, generator=g).to(dev)
    cot = torch.randn(b, t, f, hs, generator=g).to(dev)

    def projections(fb_x, sb_x, p):
        return ((fb_x @ p["fb_lstm"]["w_ih"].T + p["fb_lstm"]["b_ih"] + p["fb_lstm"]["b_hh"]),
                (sb_x @ p["sb_lstm"]["w_ih"][:, :nb].T + p["sb_lstm"]["b_ih"]
                 + p["sb_lstm"]["b_hh"]))

    with torch.no_grad():
        xp_fb, xp_sb = (a.contiguous() for a in projections(fb_in, sb_nb, params))
        ys = joint_recurrence(params, xp_fb, xp_sb)
        ys_s, save_fb, _, save_sb = joint_recurrence(params, xp_fb, xp_sb, save=True)
        same = torch.equal(ys, ys_s)
        del ys, ys_s
        g_sb = cot[None]
        g_fb = torch.randn(1, b, t, 1, hf, generator=g).to(dev)
        save_fb5 = save_fb[None, :, :, None]
        save_sb5 = save_sb[None]
        k9b = {}
        for band, gy, sv, w in (("sb", g_sb, save_sb5, sb_p["w_hh"]),
                                ("fb", g_fb, save_fb5, fb_p["w_hh"])):
            got = lstm_backward(gy, sv, w)
            torch.cuda.synchronize()
            want = lstm_backward_plain(gy, sv, w)
            k9b[band] = float((got - want).abs().max()), float(want.abs().max())
            del got, want
    k9b_rel = {band: e / sc for band, (e, sc) in k9b.items()}
    del xp_fb, xp_sb

    # the route's gradients at B = 4 against the plain joint loop's
    b4 = 4
    xs = [v[:b4].detach().clone().requires_grad_() for v in projections(fb_in, sb_nb, params)]
    ws = [params[a][k].detach().clone().requires_grad_() for a, k in _LEAVES]
    tree = {}
    for (a, k), v in zip(_LEAVES, ws):
        tree.setdefault(a, {})[k] = v
    grads, counts, entered = {}, {}, {}
    for route, fn in (("kernel", lambda: fsn_joint_fused(tree, *xs)),
                      ("plain", lambda: _joint_scan_hs(tree, *xs))):
        with plain_entries() as n:
            grads[route], counts[route] = drive(
                (joint_recurrence, lstm_backward),
                lambda: torch.autograd.grad(fn(), xs + ws, cot[:b4]))
        entered[route] = n[0]
    route_rel = max(float((a - w_).abs().max() / w_.abs().max())
                    for a, w_ in zip(grads["kernel"], grads["plain"]))
    del grads, xs, ws, tree
    phase("K9b vs plain", f"FullSubNet B = {b}, T = {t}: K11's sequence with and without saving "
          f"bit-equal {same}; K9b vs its plain version max|d| / scale: sub band ({b} x {f} rows, "
          f"H {hs}) {k9b_rel['sb']:.3e}, full band ({b} rows, H {hf}) {k9b_rel['fb']:.3e} (bar "
          f"{K9_TOL:g}); at B = {b4} the route's gradients vs the plain joint loop's, worst leaf "
          f"{route_rel:.3e} (bar {K8_GRAD_TOL:g}); launches K11 / K9b: route {counts['kernel']}, "
          f"plain {counts['plain']}; plain loops entered by the route {entered['kernel']}")
    check(same, "K11's sequence changes with the save flag")
    check(max(k9b_rel.values()) <= K9_TOL, "K9b disagrees with its plain version")
    check(counts["kernel"] == [1, 2] and counts["plain"] == [0, 0] and entered["kernel"] == 0,
          "fsn_joint_fused did not run K11 and K9b twice")
    check(route_rel <= K8_GRAD_TOL, "the route's gradients disagree with the plain route's")

    # times at B = 16: the library composition and the route, same inputs
    lstms = {}
    for name, p_, i_, h_ in (("fb", fb_p, cfg.fb_input, hf), ("sb", sb_p, cfg.sb_input, hs)):
        lstms[name] = torch.nn.LSTM(i_, h_, batch_first=True).to(dev)
        with torch.no_grad():
            for attr, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                              ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                getattr(lstms[name], attr).copy_(p_[key])
    fb_x, sb_x = fb_in.requires_grad_(), sb_nb.requires_grad_()
    lib_leaves = [fb_x, sb_x, params["fb_out"]["w"], params["fb_out"]["b"],
                  *lstms["fb"].parameters(), *lstms["sb"].parameters()]
    route_params = {a: {k: v.requires_grad_() for k, v in sub.items()}
                    for a, sub in params.items()}
    route_leaves = [fb_x, sb_x, *(route_params[a][k] for a in ("fb_lstm", "fb_out", "sb_lstm")
                                  for k in route_params[a])]
    cot_t = cot.transpose(1, 2)  # the library's rows are (utterance, bin)

    def lib_out():
        fb_seq = lstms["fb"](fb_x)[0]
        emb = torch.relu(fb_seq @ params["fb_out"]["w"].T + params["fb_out"]["b"])
        sb_in = torch.cat([sb_x, emb[..., None]], dim=-1).transpose(1, 2)
        return lstms["sb"](sb_in.reshape(b * f, t, cfg.sb_input))[0].reshape(b, f, t, hs)

    def route_out():
        return fsn_joint_fused(route_params, *projections(fb_x, sb_x, route_params))

    pairs = in_turns([lambda: torch.autograd.grad(lib_out(), lib_leaves, cot_t),
                      lambda: torch.autograd.grad(route_out(), route_leaves, cot)], reps)
    o_lib, o_route = lib_out(), route_out()
    bwd = [lambda: torch.autograd.grad(o_lib, lib_leaves, cot_t, retain_graph=True),
           lambda: torch.autograd.grad(o_route, route_leaves, cot, retain_graph=True),
           lambda: lstm_backward(g_sb, save_sb5, sb_p["w_hh"]),
           lambda: lstm_backward(g_fb, save_fb5, fb_p["w_hh"])]
    bpairs = in_turns(bwd, reps)
    del o_lib, o_route
    with torch.no_grad():
        t_pb = {"sb": time_once(lambda: lstm_backward_plain(g_sb, save_sb5, sb_p["w_hh"])),
                "fb": time_once(lambda: lstm_backward_plain(g_fb, save_fb5, fb_p["w_hh"]))}
    med = [statistics.median(p_) for p_ in pairs]
    bmed = [statistics.median(p_) for p_ in bpairs]
    fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)  # noqa: E731
    bnd = {"sb": k9b_bound(b * f, t, hs), "fb": k9b_bound(b, t, hf)}
    phase("time", f"FullSubNet's joint recurrence, B = {b}, T = {t}, in turns (4 each, ms): "
          f"forward and backward, the library composition (cuDNN nn.LSTM x 2 and the embedding) "
          f"{fmt(pairs[0])}, the route (projections, K11, K9b x 2, products) {fmt(pairs[1])}, "
          f"ratio {med[1] / med[0]:.3f}; the backwards alone: the library's {fmt(bpairs[0])}, "
          f"the route's {fmt(bpairs[1])}, K9b sub band {fmt(bpairs[2])} (plain "
          f"{t_pb['sb']:.1f}; bound {bnd['sb']['bound_ms']:.3f} ms, {bnd['sb']['bound_by']}), "
          f"K9b full band {fmt(bpairs[3])} (plain {t_pb['fb']:.1f}; bound "
          f"{bnd['fb']['bound_ms']:.4f} ms, {bnd['fb']['bound_by']}) [{smi}]")
    split = {band: k9b_split(bwd_costs, band, smi)
             for band in ("fullsubnet_sub_band", "fullsubnet_full_band")}
    return {"k9b_split_us": split, "k9b_err": max(e for e, _ in k9b.values()), "k9b_sb_ms": bmed[2],
            "k9b_fb_ms": bmed[3], "k9b_sb_plain_ms": t_pb["sb"], "k9b_fb_plain_ms": t_pb["fb"],
            "k9b_sb_bound": bnd["sb"], "k9b_fb_bound": bnd["fb"], "route_bwd_ms": bmed[1],
            "lib_bwd_ms": bmed[0], "route_fwd_bwd_ms": med[1], "lib_fwd_bwd_ms": med[0]}


def att_ccrn_phase(dev, names, s_far, s_mic, reps: int, smi: str, costs: list[dict]) -> dict:
    """25. K10 at ATT-CCRN's bottleneck (H = 4096, T = 513, B = 1) against the
    plain int8 loop, with the count of h's codes that differ, timed beside it
    (the plain loop once: its float64 product streams 537 MB a step) and,
    for information, the f32 plain loop; ``costs``' K10 row
    (kernels/lstm_costs.py); cli/infer's ATT-CCRN enhancer (att_ccrn_init,
    seed 0; --lstm_dtype auto, int8 on the card) on the 8 scenes, K1 + K10
    per utterance, against the plain route (Kalman's plain loop, the plain
    int8 loop), and its wav SNR against the f32 route; the call timed with
    the codes and their layout built (warm) and once building them first
    (cold), beside K10's device time in a call (torch.profiler)."""
    from aec_tpu_torch.cli.infer import _make_enhancer, _tree_to
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
    from aec_tpu_torch.kernels.lstm_costs import report
    from aec_tpu_torch.kernels.lstm_int8 import clear_cache as clear_k10
    from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence
    from aec_tpu_torch.kernels.serving_costs import kernel_ms
    from aec_tpu_torch.models.att_ccrn import AttCcrnConfig, att_ccrn_apply, att_ccrn_init
    from aec_tpu_torch.ops.lstm import (
        lstm_init,
        lstm_int8_recurrence_plain,
        lstm_scan,
        quantize_rows_int8,
    )
    from aec_tpu_torch.train import checkpoints

    h = 4096
    g = torch.Generator().manual_seed(0)
    lp = lstm_init(h, h, generator=g, device=dev)
    x = torch.randn(1, T_DCCRN, h, generator=g).to(dev)
    with torch.no_grad():
        xp = x @ lp["w_ih"].T + lp["b_ih"]
        w_q, w_scale = quantize_rows_int8(lp["w_hh"])
        args = (xp, w_q, w_scale / 127.0, lp["b_hh"], torch.zeros(1, h, device=dev),
                torch.zeros(1, h, device=dev))
        ys, (_, c_t) = lstm_int8_recurrence(*args)
        want, (_, c_w) = lstm_int8_recurrence_plain(*args)
        torch.cuda.synchronize()
        check(ys.shape == (1, T_DCCRN, h) and bool(torch.isfinite(ys).all()), "K10 output")
        err = max(float((ys - want).abs().max()), float((c_t - c_w).abs().max()))
        code = lambda y: torch.round(torch.clamp(y * 127.0, -127.0, 127.0))  # noqa: E731
        flips = int((code(ys) != code(want)).sum())
        t_k = time_ms(lambda: lstm_int8_recurrence(*args), reps)
        t_p = time_once(lambda: lstm_int8_recurrence_plain(*args))
        lstm_scan(lp, x[:, :8])  # warm the f32 loop's kernels
        t_f32 = time_once(lambda: lstm_scan(lp, x))
    phase("K10 vs plain", f"B = 1, T = {T_DCCRN}, H = {h}: max|d| = {err:.3e} (bar {K10_TOL:g}); "
          f"codes of h that differ: {flips} of {ys.numel()}")
    check(err <= K10_TOL, "K10 disagrees with its plain version")
    phase("time", f"K10 B = 1, T = {T_DCCRN}, H = {h}: {t_k:.3f} ms = {t_k / T_DCCRN * 1e3:.2f} "
          f"us a step (plain int8 loop {t_p:.2f} ms once; f32 plain loop {t_f32:.2f} ms, "
          f"information; the 67 MB of codes read from HBM every step alone would take "
          f"{T_DCCRN * 4 * h * h / PEAK_HBM * 1e3:.2f} ms) [{smi}]")
    for row in costs:
        if row["kernel"] == "K10":
            phase("K10 step", f"{report(row)} [{smi}]")
    out = {"err": err, "flips": flips, "ms": t_k, "plain_ms": t_p}
    del lp, x, xp, w_q, args, ys, want

    cfg = AttCcrnConfig()
    params, state = att_ccrn_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "att_ccrn.npz")
        checkpoints.save(path, {"params": params, "model_state": state})
        enhance, params = _make_enhancer("att_ccrn", path, "kalman", StftConfig(), device=dev)
        enhance_f32, _ = _make_enhancer("att_ccrn", path, "kalman", StftConfig(),
                                        lstm_dtype="f32", device=dev)
    state = _tree_to(state, dev)
    sf, sm = (torch.from_numpy(a).to(dev) for a in (s_far, s_mic))

    def plain_route(i):
        lin = kalman_cancel_plain(KalmanConfig(), sf[i:i + 1], sm[i:i + 1])["wav"]
        return att_ccrn_apply(params, state, lin, sf[i:i + 1], cfg, lstm_recurrent_dtype="int8",
                              lstm_int8_kernel=False)[0]["wav"]

    got, (k1, k10) = drive((kalman_cancel_fused_batched, lstm_int8_recurrence),
                           lambda: [enhance(sf[i:i + 1], sm[i:i + 1]) for i in range(len(names))])
    phase("att_ccrn path", f"cli/infer ATT-CCRN enhancer (--lstm_dtype auto), 8 scenes x {N} one "
          f"by one: launches K1 {k1}, K10 {k10}")
    check(k1 == len(names) and k10 == len(names),
          "the ATT-CCRN path did not run K1 + K10 per utterance")
    worst, snrs = 0.0, []
    with torch.no_grad():
        for i in range(len(names)):
            want = plain_route(i)
            check(got[i].shape == want.shape and bool(torch.isfinite(got[i]).all()),
                  "ATT-CCRN wav")
            worst = max(worst, float((got[i] - want).abs().max()) / float(want.abs().max()))
            ref = enhance_f32(sf[i:i + 1], sm[i:i + 1])
            noise = float(((got[i] - ref) ** 2).sum())
            snrs.append(10 * np.log10(float((ref ** 2).sum()) / noise) if noise else np.inf)
        t_utt = time_ms(lambda: enhance(sf[:1], sm[:1]), reps)
        t_cold = time_once(lambda: (clear_k10(), enhance(sf[:1], sm[:1])))
        t_k10 = kernel_ms(lambda: enhance(sf[:1], sm[:1]), reps, "lstm_int8_kernel")
        t_plain = time_once(lambda: plain_route(0))
        t_f32 = time_ms(lambda: enhance_f32(sf[:1], sm[:1]), 1)
    phase("att_ccrn path", "int8 route vs f32 route, wav SNR dB: " + ", ".join(
        f"{k} {v:.2f}" for k, v in zip(names, snrs)) + f" (bar >= {INT8_SNR_MIN_DB:g})")
    phase("att_ccrn path", f"kernel vs plain route: worst max|d| / scale = {worst:.3e} (bar "
          f"{ENHANCER_WAV_TOL:g}); {t_utt:.2f} ms per 8.2 s utterance = "
          f"{N / SR / (t_utt / 1e3):.1f} x realtime (plain route {t_plain:.1f} ms once; f32 route "
          f"{t_f32:.1f} ms) [{smi}]")
    phase("att_ccrn path", f"the call with the codes prepared (warm) {t_utt:.2f} ms, quantizing "
          f"and laying them out first (cold) {t_cold:.2f} ms; K10's device time in a call "
          f"{t_k10:.3f} ms [{smi}]")
    check(worst <= ENHANCER_WAV_TOL, "the ATT-CCRN kernel route disagrees with its plain route")
    check(min(snrs) >= INT8_SNR_MIN_DB, "the ATT-CCRN int8 route is off its f32 route")
    out["launches"] = k10
    return out


def keyed(tree) -> dict[str, torch.Tensor]:
    """A tree's leaves by their checkpoint key (``['encoder'][0]['bn']['m_r']``)."""
    from aec_tpu_torch.train.checkpoints import tree_map_with_path

    out = {}
    tree_map_with_path(tree, out.__setitem__)
    return out


def grad_check(got: dict, want: dict, exact_zeros: set[str]) -> tuple[float, str, float]:
    """Two routes' gradient trees: the worst max|d| over the leaf's scale
    and that leaf (a leaf of scale 0, a parameter the loss does not reach,
    must be 0 in both); the leaves at ``exact_zeros`` are round-off in both
    routes, and the largest of them over the largest leaf's scale is
    returned instead."""
    got, want = keyed(got), keyed(want)
    top = max(float(w.abs().max()) for w in want.values())
    worst, where, zero = 0.0, "", 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        scale, d = float(w.abs().max()), float((g - w).abs().max())
        if k in exact_zeros:
            zero = max(zero, scale / top, float(g.abs().max()) / top)
        elif (d / scale if scale else (math.inf if d else 0.0)) > worst:
            worst, where = d / scale if scale else math.inf, k
    return worst, where, zero


def bn_state_err(got: dict, want: dict) -> float:
    """The worst max|d| of a BatchNorm statistic over its BatchNorm's scale."""
    got, want = keyed(got), keyed(want)
    scale: dict = {}
    for k, w in want.items():
        bn = k.rsplit("[", 1)[0]
        scale[bn] = max(scale.get(bn, 1e-12), float(w.abs().max()))
    return max((float((got[k].to(w.device) - w).abs().max()) / scale[k.rsplit("[", 1)[0]]
                for k, w in want.items()), default=0.0)


def step_profile(fn, n: int = 4) -> tuple[float, list[tuple[str, float, int]]]:
    """One call of ``fn`` under torch.profiler: the device's busy ms (the
    kernels' device time summed) and the ``n`` kernels with the most device
    time (name, ms, count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    return (sum(e.device_time_total for e in rows) / 1e3,
            [(e.key[:60], e.device_time_total / 1e3, e.count) for e in rows[:n]])


def zoo_phase(dev, seed: int, reps: int, smi: str) -> dict:
    """26. Zoo training: two_layer_gru, dccrn, fullsubnet and att_ccrn at
    their default configs through cli/train's trainers' pieces
    (make_adapter, make_optimizer at TrainConfig(),
    make_stateful_train_step) on 16 scenes x 8 s (bench config #7's
    shape): the first step on the kernel route against the plain route
    (DCCRN: K9 and K9b against ``lstm_fused=False``; FullSubNet: K11 and
    K9b against ``joint_kernel=False``; TwoLayerGRU's step runs K8 and K8b, and
    ``two_layer_gru_apply`` has no switch to the plain loop, so its card
    reference is the same route, and ATT-CCRN runs no kernel in a batch-16
    step: both are also held against the CPU route), cuDNN's TF32 off and
    deterministic: loss, every gradient leaf, the new BatchNorm state; the
    kernels' launches in that step and in validation of 8 scenes at batch 1
    (K8, K9, K11, K8b, K9b) and the plain LSTM loops the kernel route
    entered (none); 3 more steps timed by the host
    clock ending in a synchronize (cuDNN at its defaults, TF32 on and
    nondeterministic, as a user's run has it), train_xrt and peak memory;
    a checkpoint round trip (save_latest_best -> restore_train_tree into a
    fresh net: params, opt_state and model_state bit-equal). Then DCT-DNN
    and DCT-CNN: one step against the CPU route (the DCT-CNN's H = 512 GRU
    on the wide K8 and K8b once each, no plain GRU loop entered; the DCT-DNN
    runs no kernel), and the step timed."""
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.kernels.gru import gru_backward, gru_recurrence
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward
    from aec_tpu_torch.models.dct_net import DctCnn, DctDnn
    from aec_tpu_torch.models.registry import get_model
    from aec_tpu_torch.models.tree_net import (
        bias_keys_before_batch_norm,
        copy_into,
        functional_params,
        model_state,
    )
    from aec_tpu_torch.train import checkpoints
    from aec_tpu_torch.train.generic import make_adapter
    from aec_tpu_torch.train.loop import (
        make_optimizer,
        make_stateful_train_step,
        restore_train_tree,
        train_tree,
    )
    from aec_tpu_torch.utils.weights import param_tree
    from benchmarks.scenes import make_scenes

    t_phase = time.perf_counter()
    cfg = TrainConfig()
    scenes = [sc for sd in (seed, seed + 1)
              for sc in make_scenes(np.random.default_rng(sd), n=N_TRAIN).values()]
    far, mic, near = (torch.from_numpy(np.stack([sc[i] for sc in scenes])) for i in range(3))
    batch_c = (mic, far, near, mic - near)  # mic, far, near, echo
    batch = tuple(t.to(dev) for t in batch_c)
    audio_s = cfg.batch_size * N_TRAIN / SR
    kernels = (gru_recurrence, grouped_lstm_recurrence, joint_recurrence, gru_backward,
               lstm_backward)
    none = (0, 0, 0, 0, 0)
    expect_step = {"two_layer_gru": (1, 0, 0, 1, 0), "dccrn": (0, 2, 0, 0, 2),
                   "fullsubnet": (0, 0, 1, 0, 2)}
    expect_val = {"two_layer_gru": (8, 0, 0, 0, 0), "dccrn": (0, 16, 0, 0, 0),
                  "fullsubnet": (0, 0, 8, 0, 0)}
    plain_kw = {"dccrn": {"lstm_fused": False}, "fullsubnet": {"joint_kernel": False}}

    def stepper(adapter, net, **kw):
        opt = make_optimizer(cfg, 1, net)

        def loss_fn(p, s, *b):
            loss, new_state = adapter.loss(p, s, *b, True, **kw)
            return loss, {"state": new_state}

        return opt, make_stateful_train_step(loss_fn, opt)

    def first_step(adapter, net, data, **kw):
        """One step: (loss, gradients, new state, the kernels' launches)."""
        opt, step = stepper(adapter, net, **kw)
        (new_state, loss), counts = drive(kernels, lambda: step(model_state(net), *data))
        grads = param_tree(net, lambda p: p.grad.detach().clone())
        copy_into(model_state(net), new_state)
        return float(loss), grads, new_state, counts, opt, step

    out = {}
    torch.backends.cudnn.deterministic = True  # for the comparisons (module top)
    for name in ZOO:
        adapter = make_adapter(name)
        init = adapter.init(generator=torch.Generator().manual_seed(seed), device=dev)
        net = adapter.module(*init)
        ref = copy.deepcopy(net)
        zeros = bias_keys_before_batch_norm(param_tree(net))
        with plain_entries() as entered:
            loss, grads, state, counts, opt, step = first_step(adapter, net, batch)
        ref_loss, ref_grads, ref_state, ref_counts, _, _ = first_step(
            adapter, ref, batch, **plain_kw.get(name, {}))
        check(np.isfinite(loss), f"{name} loss not finite")
        rel = abs(loss / ref_loss - 1.0)
        g_err, g_leaf, g_zero = grad_check(grads, ref_grads, zeros)
        s_err = bn_state_err(state, ref_state)
        want_step = expect_step.get(name, none)
        # the card reference of a family without a plain-route switch is its
        # own route (the CPU route below holds it)
        want_ref = none if name in plain_kw else want_step
        phase("zoo", f"{name} step 1, batch {cfg.batch_size} x {N_TRAIN}: launches K8 / K9 / K11 / "
              f"K8b / K9b {counts} (card reference {ref_counts}), plain LSTM loops entered "
              f"{entered[0]}; loss {loss:.6f} vs card reference "
              f"{ref_loss:.6f} (rel {rel:.2e}, bar {STEP_LOSS_TOL:g}); worst gradient leaf "
              f"{g_leaf} {g_err:.3e} of its scale (bar {K8_GRAD_TOL:g}); {len(zeros)} biases "
              f"before a BatchNorm (exact zeros) up to {g_zero:.2e} of the largest leaf (bar "
              f"{ZERO_GRAD:g}); BatchNorm state {s_err:.3e} (bar {STATE_TOL:g})")
        check(tuple(counts) == want_step and tuple(ref_counts) == want_ref and entered[0] == 0,
              f"{name}'s train step did not launch its kernels as routed")
        check(rel <= STEP_LOSS_TOL and g_err <= K8_GRAD_TOL and g_zero <= ZERO_GRAD
              and s_err <= STATE_TOL,
              f"{name}'s first step on the kernel route disagrees with the plain route")
        del ref, ref_grads, ref_state
        if name not in plain_kw:  # no plain-route switch: the CPU route
            cpu = adapter.module(*adapter.init(generator=torch.Generator().manual_seed(seed),
                                               device="cpu"))
            c_loss, c_grads, c_state, _, _, _ = first_step(adapter, cpu, batch_c)
            c_rel = abs(loss / c_loss - 1.0)
            # every summation order differs here (cuDNN's and the CPU's
            # convolutions and products), which a gradient that cancels (a
            # conv before a BatchNorm) feels at ~1e-3 of its scale: held,
            # as the LittleNet trainer's first step is, by the loss and by
            # the parameters after the update (Adam's step follows each
            # element's gradient sign), the exact zeros left out of the
            # latter (each route moves them by +-lr on its round-off)
            c_err, c_leaf, c_zero = grad_check(grads, c_grads, zeros)
            cs_err = bn_state_err(state, c_state)
            moved = keyed(param_tree(cpu))
            mean_d = max(float((p.detach().cpu() - moved[k].detach()).abs().mean())
                         for k, p in keyed(param_tree(net)).items() if k not in zeros)
            phase("zoo", f"{name} step 1 vs the CPU route: loss {c_loss:.6f} (rel {c_rel:.2e}, "
                  f"bar {STEP_LOSS_TOL:g}); BatchNorm state {cs_err:.3e} (bar {STATE_TOL:g}); "
                  f"worst leaf mean|d| after the update {mean_d:.3e} (bar {STEP_PARAM_TOL:g} x "
                  f"lr, the exact zeros left out); exact zeros' gradients up to {c_zero:.2e} of "
                  f"the largest leaf (bar {ZERO_GRAD:g}); worst gradient leaf {c_leaf} "
                  f"{c_err:.3e} of its scale (information)")
            check(c_rel <= STEP_LOSS_TOL and c_zero <= ZERO_GRAD and cs_err <= STATE_TOL
                  and mean_d <= STEP_PARAM_TOL * cfg.lr,
                  f"{name}'s first step disagrees with the CPU route")
            del cpu, c_grads, c_state
        del grads

        # the library's defaults, as a user's run has them
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, step_counts = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            (new_state, l), c = drive(kernels, lambda: step(model_state(net), *batch))
            copy_into(model_state(net), new_state)
            losses.append(float(l))
            times.append((time.perf_counter() - t0) * 1e3)
            step_counts.append(tuple(c))
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the forward alone (autograd recording, as in a step): the rest of a
        # step is the backward and the update
        t0 = time.perf_counter()
        float(adapter.loss(functional_params(net), model_state(net), *batch, True)[0])
        t_fwd = (time.perf_counter() - t0) * 1e3
        busy, top = step_profile(lambda: copy_into(model_state(net),
                                                   step(model_state(net), *batch)[0]))
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
        t_step = statistics.median(times)
        xrt = audio_s / (t_step / 1e3)
        check(all(np.isfinite(losses)) and all(c == want_step for c in step_counts),
              f"{name}'s timed steps")
        phase("zoo", f"{name}: one step under torch.profiler: device busy {busy:.1f} ms "
              f"({busy / t_step:.0%} of the median step); top kernels by device time: "
              + "; ".join(f"{k} {ms:.1f} ms x {n}" for k, ms, n in top))

        params, state = functional_params(net), model_state(net)

        @torch.no_grad()
        def validate():
            return [float(adapter.loss(params, state, *(t[i:i + 1] for t in batch), False)[0])
                    for i in range(8)]

        cv, val_counts = drive(kernels, validate)
        check(all(np.isfinite(cv)), f"{name} validation loss")
        check(tuple(val_counts) == expect_val.get(name, none),
              f"{name}'s batch-1 validation did not launch its kernels as routed: {val_counts}")
        phase("zoo", f"{name}: 3 steps {', '.join(f'{v:.1f}' for v in times)} ms (median "
              f"{t_step:.1f} ms = train_xrt {xrt:.1f}; the forward alone {t_fwd:.1f} ms), "
              f"losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}; peak memory {peak:.2f} GiB; "
              f"launches K8 / K9 / K11 / K8b / K9b a step {step_counts[0]}, in validation of 8 "
              f"scenes at "
              f"batch 1 {tuple(val_counts)}; cv loss {np.mean(cv):.5f} [{smi}]")

        with tempfile.TemporaryDirectory() as d:
            tree = train_tree(opt)
            latest = checkpoints.save_latest_best(d, tree, {"cur_epoch": 0, "model": name}, False)
            fresh = adapter.module(*adapter.init(
                generator=torch.Generator().manual_seed(seed + 7), device=dev))
            fresh_opt = make_optimizer(cfg, 1, fresh)
            restore_train_tree(latest, fresh_opt)
            want, got = leaves(tree), leaves(train_tree(fresh_opt))
            same = len(want) == len(got) and all(np.array_equal(a, b) for a, b in zip(want, got))
        phase("zoo", f"{name}: save_latest_best -> restore_train_tree: {len(want)} leaves "
              f"(params, opt_state, model_state) bit-equal {same}, count {fresh_opt.count}")
        check(same and fresh_opt.count == opt.count == 5, f"{name} checkpoint round trip")
        out[name] = {"step_ms": t_step, "train_xrt": xrt, "peak_gib": peak, "forward_ms": t_fwd,
                     "step_launches": step_counts[0], "validation_launches": tuple(val_counts)}
        del net, opt, step, fresh, fresh_opt, tree, params, state
        torch.cuda.empty_cache()

    # DCT-DNN and DCT-CNN (no adapter, no CLI in either package): their
    # registry loss on the denoising contract (noisy mic -> clean near end)
    expect_dct = {"dct_dnn": none, "dct_cnn": (1, 0, 0, 1, 0)}
    for name, cls in (("dct_dnn", DctDnn), ("dct_cnn", DctCnn)):
        spec = get_model(name)
        nets = [cls(spec.init(generator=torch.Generator().manual_seed(seed), device=d))
                for d in (dev, "cpu")]
        steps = []
        for n in nets:
            opt = make_optimizer(cfg, 1, n)
            steps.append(make_stateful_train_step(
                lambda p, s, m, f, ne, e: (spec.loss(p, m, ne)[0], {"state": s}), opt))
        wide = (gru_recurrence.wide_launches, gru_backward.wide_launches)
        with plain_entries() as entered:
            loss, counts = drive(kernels, lambda: float(steps[0]({}, *batch)[1]))
        wide = (gru_recurrence.wide_launches - wide[0], gru_backward.wide_launches - wide[1])
        check(tuple(counts) == expect_dct[name] and entered[0] == 0
              and wide == tuple(expect_dct[name][::3]),
              f"{name}'s step did not launch its kernels as routed: {counts}, wide {wide}, "
              f"plain GRU or LSTM loops entered {entered[0]}")
        c_loss = float(steps[1]({}, *batch_c)[1])
        rel = abs(loss / c_loss - 1.0)
        mean_d = max(float((p.detach().cpu() - q.detach()).abs().mean())
                     for p, q in zip(nets[0].parameters(), nets[1].parameters()))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(steps[0]({}, *batch)[1])
            times.append((time.perf_counter() - t0) * 1e3)
        t_step = statistics.median(times)
        phase("zoo", f"{name} step 1, batch {cfg.batch_size} x {N_TRAIN}: launches K8 / K9 / K11 / "
              f"K8b / K9b {counts} (on the wide path {wide}), plain loops entered "
              f"{entered[0]}; loss {loss:.6f} vs the "
              f"CPU route {c_loss:.6f} (rel {rel:.2e}, bar {STEP_LOSS_TOL:g}); worst leaf "
              f"mean|d| after the update {mean_d:.3e} (bar {STEP_PARAM_TOL:g} x lr); 3 steps "
              f"{', '.join(f'{v:.1f}' for v in times)} ms (median {t_step:.1f} ms = train_xrt "
              f"{audio_s / (t_step / 1e3):.1f}) [{smi}]")
        check(rel <= STEP_LOSS_TOL and mean_d <= STEP_PARAM_TOL * cfg.lr,
              f"{name}'s step disagrees with the CPU route")
        out[name] = {"step_ms": t_step, "train_xrt": audio_s / (t_step / 1e3),
                     "step_launches": tuple(counts), "wide_launches": wide}
    torch.backends.cudnn.deterministic = False
    wall = time.perf_counter() - t_phase
    phase("zoo", f"phase wall time {wall:.1f} s")
    print("zoo_train " + " ".join(
        f"{k}_step_ms={v['step_ms']:.2f} {k}_train_xrt={v['train_xrt']:.1f}"
        + (f" {k}_peak_gib={v['peak_gib']:.2f}" if "peak_gib" in v else "")
        for k, v in out.items()), flush=True)
    return out


def run_cli(main_fn, argv: list[str]) -> str:
    """A CLI's ``main(argv)`` with its standard output captured and returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    return buf.getvalue()


def data_phase(dev, seed: int, smi: str) -> dict:
    """27. The data pipeline and the CLIs on the card: (a) prepare_data
    packs 8 scenes x 8 s of wav quadruples (train and test); (b) an int16
    device cache of CACHE_UTTS x 10 s built through ``device_cache._build``,
    its build rate, its peak memory during assembly and a gathered batch of
    16 against the host rows; (c) the trainer at ``TrainConfig()`` for two
    epochs over DATA_UTTS scenes from a float32 cache, from the host loader
    and from an int16 cache, the same initial net: per-step losses and
    parameters, K8's and K8b's launches (one each a step, K8 once per cv
    utterance in cached validation), step ms of each epoch (the second
    without the first step's set-up); (d) batch_enhance at --batch 8 with
    each stage 1 (K1 / K5 and K8 once a batch) against the same CLI on the
    CPU; (e) stream on one scene against the CLI
    on the CPU, its block latencies; (f) export_pt, then infer with the .pt
    and the .npz: bit-equal wavs, the same launches; (g) measure over (d)'s
    outputs and profile of every family. On a machine without h5py the .ex
    files go through :func:`npz_h5py`."""
    import importlib.util

    from aec_tpu_torch.cli import (
        batch_enhance,
        export_pt,
        infer,
        measure,
        prepare_data,
        profile,
        stream,
    )
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.kernels.gru import gru_backward, gru_recurrence
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched
    from aec_tpu_torch.kernels.nlms import nlms_cancel_fused_batched
    from aec_tpu_torch.models.little_net import little_net_loss
    from aec_tpu_torch.pipeline import device_cache as dc
    from aec_tpu_torch.pipeline import h5io
    from aec_tpu_torch.pipeline.audio_io import read_wav, write_wav
    from aec_tpu_torch.train.loop import Trainer
    from aec_tpu_torch.utils.weights import params_to_jax
    from benchmarks.scenes import make_scenes

    t_phase = time.perf_counter()
    card = str(dev)
    if importlib.util.find_spec("h5py") is None:
        sys.modules["h5py"] = npz_h5py()
        phase("data", "no h5py on this machine: the .ex files go through chip_smoke's npz "
              "stand-in (the h5 format is held to JAX's on the CPU)")
    out: dict = {}
    with tempfile.TemporaryDirectory() as work:
        # (a) 8 scenes x 8 s as wav quadruples, packed as train and test
        scenes = make_scenes(np.random.default_rng(seed + 2), n=N_TRAIN)
        names = list(scenes)
        wav_dir, h5_dir, lists = (os.path.join(work, d) for d in ("wavs", "h5", "lists"))
        os.makedirs(wav_dir)
        for i, (far, mic, near) in enumerate(scenes.values()):
            for key, x in (("nearend_speech", near), ("nearend_mic", mic),
                           ("farend_speech", far), ("echo", mic - near)):
                write_wav(os.path.join(wav_dir, f"{key}_fileid_{i}.wav"), x, SR)
        t0 = time.perf_counter()
        for split in ("train", "test"):
            run_cli(prepare_data.main, [split, "--wav_path", wav_dir, "--h5_path", h5_dir,
                                        "--list_path", lists])
        t_prep = time.perf_counter() - t0
        tr_files = h5io.read_filelist(os.path.join(lists, "tr_list.txt"))
        (test_ex,) = h5io.read_filelist(os.path.join(lists, "tt_list.txt"))
        packed = [h5io.read_group(test_ex, i) for i in range(h5io.group_count(test_ex))]
        same = len(tr_files) == len(packed) == len(names) and all(
            np.array_equal(u["nearend_mic"], sc[1]) and np.array_equal(
                h5io.read_utterance(p)["farend_speech"], sc[0])
            for u, p, sc in zip(packed, tr_files, scenes.values()))
        phase("data", f"prepare_data train + test: {len(tr_files)} scenes x {N_TRAIN} in "
              f"{t_prep:.2f} s; read back bit-equal {same}")
        check(same, "prepare_data's files do not hold the wavs")

        # (b) the int16 device cache at size, from host rows made on the card
        g = torch.Generator(device=dev).manual_seed(seed)
        host = {k: np.concatenate([(0.1 * torch.randn(64, CACHE_LEN, generator=g, device=dev))
                                   .cpu().numpy() for _ in range(CACHE_UTTS // 64)])
                for k in dc.CACHE_KEYS}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        corpus = dc._build(({k: host[k][i] for k in dc.CACHE_KEYS} for i in range(CACHE_UTTS)),
                           CACHE_UTTS, dtype="int16", bucket_quantum=CACHE_LEN, device=dev)
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        nbytes = sum(a.numel() * a.element_size() for a in corpus.arrays.values())
        chunk = 64 << 20
        idx = torch.randperm(CACHE_UTTS, generator=torch.Generator().manual_seed(seed))[:16]
        with torch.no_grad():
            steps = [float((corpus.take(k, idx.to(dev)).cpu() - torch.from_numpy(host[k][idx]))
                           .abs().max()) / (corpus.scales[k] / 32767.0) for k in dc.CACHE_KEYS]
        phase("data", f"device_cache int16 {CACHE_UTTS} x {CACHE_LEN} x 3 roles = "
              f"{nbytes / 1e9:.3f} GB: build {build_s:.2f} s = {nbytes / 1e9 / build_s:.3f} GB/s "
              f"(host quantize + pinned copies); peak device memory in assembly "
              f"{peak / 1e9:.3f} GB (bar: the cache + two 64 MB chunks = "
              f"{(nbytes + 2 * chunk) / 1e9:.3f}); take of 16 rows: max|d| "
              f"{max(steps):.3f} int16 steps (bar {CACHE_STEP_TOL}) [{smi}]")
        check(peak <= nbytes + 2 * chunk, "device_cache assembly held more than the cache")
        check(max(steps) <= CACHE_STEP_TOL, "device_cache rows disagree with the host rows")
        del corpus, host

        # (c) the trainer from the cache and from the host loader, one epoch
        rows = [u for sd in range(DATA_UTTS // len(names)) for u in
                make_scenes(np.random.default_rng(seed + 10 + sd), n=N_TRAIN).values()]
        files = []
        for i, (far, mic, near) in enumerate(rows):
            files.append(os.path.join(work, f"tr_{i}.ex"))
            h5io.write_utterance(files[-1], {"nearend_speech": near, "nearend_mic": mic,
                                             "farend_speech": far, "echo": mic - near})
        cfg = TrainConfig(max_n_epochs=2)  # the second epoch times the loop without set-up
        runs = {}
        for tag in ("", "float32", "int16"):
            losses: list = []

            def recording(net, *args, **kw):
                loss, aux = little_net_loss(net, *args, **kw)
                if torch.is_grad_enabled():
                    losses.append(loss.detach())
                return loss, aux

            ckpt = os.path.join(work, f"exp_{tag or 'host'}")
            res, (k8, k8b) = drive((gru_recurrence, gru_backward), lambda: Trainer(
                files, test_ex, ckpt, cfg=cfg, loss_fn=recording, device_cache=tag,
                time_log=os.path.join(ckpt, "time.log"), device=dev).train())
            with open(os.path.join(ckpt, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
            with open(os.path.join(ckpt, "time.log")) as f:
                step_s = [float(line.rsplit("=", 1)[1]) for line in f]
            runs[tag] = {"losses": [float(v) for v in losses], "k8": k8 - k8b, "k8b": k8b,
                         "metrics": metrics,
                         "params": params_to_jax(res["net"]), "step_s": step_s}
        host_run, cached, q = runs[""], runs["float32"], runs["int16"]
        n_steps = DATA_UTTS // cfg.batch_size * cfg.max_n_epochs
        loss_rel = max(abs(a / b - 1.0) for a, b in zip(cached["losses"], host_run["losses"]))
        param_rel = max(float(np.abs(cached["params"][a][b] - w).max())
                        / max(float(np.abs(w).max()), 1e-12)
                        for a in host_run["params"] for b, w in host_run["params"][a].items())
        bit_equal = cached["losses"] == host_run["losses"] and param_rel == 0.0
        q_gap = max(abs(a / b - 1.0) for a, b in zip(q["losses"], cached["losses"]))
        half = n_steps // 2
        phase("data", f"trainer, TrainConfig() two epochs over {DATA_UTTS} x {N_TRAIN} "
              f"({n_steps} steps): float32 cache vs host loader per-step losses rel "
              f"{loss_rel:.2e}, parameters max|d| / scale {param_rel:.2e} (bars {CACHED_TOL:g}); "
              f"bit-equal {bit_equal}; int16 cache loss gap to float32 {q_gap:.2e}; losses "
              f"{', '.join(f'{v:.4f}' for v in cached['losses'])}")
        check(len(cached["losses"]) == len(host_run["losses"]) == n_steps and
              loss_rel <= CACHED_TOL and param_rel <= CACHED_TOL,
              "the cached trainer disagrees with the host loader")
        for e in range(cfg.max_n_epochs):
            steps = host_run["step_s"][e * half:(e + 1) * half]
            phase("data", f"epoch {e + 1} step ms: host loader median "
                  f"{statistics.median(steps) * 1e3:.1f}, mean {statistics.mean(steps) * 1e3:.1f} "
                  f"(steps {', '.join(f'{v * 1e3:.1f}' for v in steps)}); float32 cache "
                  f"{cached['metrics'][e]['batch_time_s'] * 1e3:.1f}, int16 cache "
                  f"{q['metrics'][e]['batch_time_s'] * 1e3:.1f} (epoch / steps: no wait on the "
                  f"card inside an epoch, so no step of its own); train_xrt host "
                  f"{host_run['metrics'][e]['train_xrt']}, float32 cache "
                  f"{cached['metrics'][e]['train_xrt']}, int16 cache "
                  f"{q['metrics'][e]['train_xrt']} [{smi}]")
        phase("data", f"the {n_steps} steps: launches K8 and K8b {cached['k8b']} each (host "
              f"loader {host_run['k8b']}, int16 cache {q['k8b']}); cached validation of "
              f"{len(names)} scenes at batch 1, each epoch: launches K8 {cached['k8']} (int16 "
              f"cache {q['k8']})")
        check(cached["k8b"] == q["k8b"] == host_run["k8b"] == n_steps,
              "the trainer's steps did not launch K8 and K8b once each")
        check(cached["k8"] == q["k8"] == cfg.max_n_epochs * len(names),
              "cached validation did not launch K8 once per cv utterance")
        out["k8_cached"], out["k8b_cached"] = cached["k8"], cached["k8b"]

        # (d) batch_enhance on test.ex at --batch 8, each stage 1, card and CPU
        mic_scale = max(float(np.abs(sc[1]).max()) for sc in scenes.values())
        for stage1, kernel in (("kalman", kalman_cancel_fused_batched),
                               ("nlms", nlms_cancel_fused_batched)):
            wavs = {}
            for tag, d in (("card", card), ("cpu", "cpu")):
                argv = ["--tt_list", os.path.join(lists, "tt_list.txt"), "--model_file",
                        "checkpoints/little_net_robust.npz", "--out_dir",
                        os.path.join(work, f"bulk_{stage1}_{tag}"), "--batch", "8", "--stage1",
                        stage1, "--device", d]
                report, counts = drive((kernel, gru_recurrence),
                                       lambda: run_cli(batch_enhance.main, argv))
                if tag == "card":
                    launches, xrt = counts, json.loads(report.strip().splitlines()[-1])["xrt"]
                wavs[tag] = [read_wav(os.path.join(work, f"bulk_{stage1}_{tag}",
                                                   f"{k}_enhanced.wav"))[0] for k in range(8)]
            err = max(float(np.abs(a - b).max()) for a, b in zip(wavs["card"], wavs["cpu"]))
            phase("data", f"batch_enhance --stage1 {stage1} --batch 8, 8 x {N_TRAIN}: launches "
                  f"{'K1' if stage1 == 'kalman' else 'K5'} {launches[0]}, K8 {launches[1]}; "
                  f"wavs vs the CPU run max|d| {err:.3e} (bar {STAGE1_TOL:g} x max|mic| = "
                  f"{STAGE1_TOL * mic_scale:.3e}); xrt {xrt} [{smi}]")
            check(launches == [1, 1], "batch_enhance did not launch its stage-1 kernel and K8 once")
            check(err <= STAGE1_TOL * mic_scale, "batch_enhance on the card disagrees with the CPU")
            out[f"{stage1}_bulk_launches"] = launches[0]
            out["k8_bulk_launches"] = launches[1]

        # (e) stream one scene hop by hop, card and CPU
        far_wav = os.path.join(wav_dir, "farend_speech_fileid_0.wav")
        mic_wav = os.path.join(wav_dir, "nearend_mic_fileid_0.wav")
        streamed = {}
        for tag, d in (("card", card), ("cpu", "cpu")):
            path = os.path.join(work, f"stream_{tag}.wav")
            report = run_cli(stream.main, ["--far", far_wav, "--mic", mic_wav, "--out", path,
                                           "--stage1", "kalman", "--device", d])
            streamed[tag] = (read_wav(path)[0], json.loads(report.strip().splitlines()[-1]))
        (got, rep), (want, _) = streamed["card"], streamed["cpu"]
        s_rel = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-9)
        phase("data", f"stream --stage1 kalman, {names[0]} ({rep['blocks']} hops): vs the CPU "
              f"run max|d| / scale {s_rel:.3e} (bar {STREAM_TOL:g}); block latency p50 "
              f"{rep['latency_ms_p50']} ms, p95 {rep['latency_ms_p95']} ms (a block is "
              f"{rep['block_ms']} ms): realtime {rep['realtime']} [{smi}]")
        check(got.shape == want.shape == (N_TRAIN,) and s_rel <= STREAM_TOL,
              "stream on the card disagrees with the CPU")

        # (f) export_pt, then infer with the .pt and with the .npz
        pt = os.path.join(work, "robust.pt")
        run_cli(export_pt.main, ["--model_file", "checkpoints/little_net_robust.npz",
                                 "--out", pt])
        est = {}
        for tag, model in (("npz", "checkpoints/little_net_robust.npz"), ("pt", pt)):
            argv = ["--tt_list", os.path.join(lists, "tt_list.txt"), "--ckpt_dir",
                    os.path.join(work, f"infer_{tag}"), "--model_file", model, "--est_path",
                    os.path.join(work, f"est_{tag}"), "--stage1", "kalman", "--device", card]
            _, counts = drive((kalman_cancel_fused_batched, gru_recurrence),
                              lambda: run_cli(infer.main, argv))
            est[tag] = (counts, [read_wav(os.path.join(work, f"est_{tag}", "test",
                                                       f"{k}_near_est.wav"))[0]
                                 for k in range(len(names))])
        pt_same = all(np.array_equal(a, b) for a, b in zip(est["pt"][1], est["npz"][1]))
        phase("data", f"export_pt -> infer with the .pt: {len(names)} scenes bit-equal to the "
              f".npz run {pt_same}; launches K1 / K8 {est['pt'][0]} (.npz run {est['npz'][0]})")
        check(pt_same and est["pt"][0] == est["npz"][0] == [len(names), len(names)],
              "infer with the .pt differs from the .npz run")
        out["infer_pt_launches"] = est["pt"][0]

        # (g) measure over (d)'s Kalman outputs; profile every family
        erles = []
        for k, (far, mic, near) in enumerate(scenes.values()):
            argv = ["--est", os.path.join(work, "bulk_kalman_card", f"{k}_enhanced.wav"),
                    "--ref", os.path.join(wav_dir, f"nearend_speech_fileid_{k}.wav"),
                    "--mic", os.path.join(wav_dir, f"nearend_mic_fileid_{k}.wav")]
            if names[k] == "speech_dtalk":  # the scene whose near end is speech
                argv += ["--metrics", "stoi,sisnr,snr,erle,pesq", "--allow-approx-pesq"]
            else:
                argv += ["--metrics", "erle"]
            scores = json.loads(run_cli(measure.main, argv))["mean"]
            erles.append(scores["erle"])
            if names[k] == "speech_dtalk":
                dtalk = scores
        phase("data", "measure over batch_enhance's Kalman wavs, ERLE dB: " + ", ".join(
            f"{n} {e:.2f}" for n, e in zip(names, erles)) + "; speech_dtalk " + ", ".join(
            f"{m} {v:.3f}" for m, v in dtalk.items()))
        check(all(np.isfinite(erles)) and all(np.isfinite(list(dtalk.values()))),
              "measure's scores are not finite")
        rows = json.loads(run_cli(profile.main, []))
        for r in rows:
            phase("data", f"profile {r['model']}: {r['params']:,d} params ({r['param_mb']} MB), "
                  f"{r['flops_per_call']:.4g} flops per 16,384-sample call (torch's count, CPU)")
        check(len(rows) == 7 and all(r["params"] > 0 and r["flops_per_call"] > 0 for r in rows),
              "profile rows")
    phase("data", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def step_diff(a: tuple, b: tuple, lr: float) -> tuple[bool, float, float, float]:
    """Two steps' (loss, params[, state]) from one initial net: (bit-equal,
    the loss's relative difference, the worst leaf's mean |d| over lr, the
    worst BatchNorm statistic over its BatchNorm's scale)."""
    pa, pb = keyed(a[1]), keyed(b[1])
    same = a[0] == b[0] and all(torch.equal(pa[k], pb[k]) for k in pa)
    rel = abs(a[0] / b[0] - 1.0)
    mean_lr = max(float((pa[k] - pb[k]).abs().mean()) / lr for k in pa)
    s_err = bn_state_err(a[2], b[2]) if len(a) > 2 and a[2] else 0.0
    if len(a) > 2 and a[2]:
        sa, sb = keyed(a[2]), keyed(b[2])
        same = same and all(torch.equal(sa[k], sb[k]) for k in sa)
    return same, rel, mean_lr, s_err


def check_steps(tag: str, meshed: tuple, plain: tuple, again: tuple, lr: float) -> None:
    """The mesh route's step against the unsharded one: bit-equal, or within
    the trainer's bars (phase 18: loss rtol STEP_LOSS_TOL, each leaf's mean
    |d| <= STEP_PARAM_TOL lr; BatchNorm state STATE_TOL of its scale), with
    the unsharded route run twice beside it: where that differs from itself,
    the card's backward sums some gradients with atomics in no fixed order."""
    same, rel, mean_lr, s_err = step_diff(meshed, plain, lr)
    if same:
        phase("parallel", f"{tag}: the mesh route's loss, parameters and state bit-equal to "
              f"the unsharded route's")
        return
    self_same, self_rel, self_lr, self_s = step_diff(again, plain, lr)
    phase("parallel", f"{tag}: mesh vs unsharded loss rel {rel:.2e} (bar {STEP_LOSS_TOL:g}), "
          f"worst leaf mean|d| {mean_lr:.2e} lr (bar {STEP_PARAM_TOL:g}), state {s_err:.2e} (bar "
          f"{STATE_TOL:g}); not bit-equal because the unsharded route run twice is not either "
          f"({'bit-equal' if self_same else f'loss rel {self_rel:.2e}, {self_lr:.2e} lr, state {self_s:.2e}'})")
    check(rel <= STEP_LOSS_TOL and mean_lr <= STEP_PARAM_TOL and s_err <= STATE_TOL,
          f"{tag}: the mesh route's step is off the unsharded one")


def parallel_phase(dev, seed: int, reps: int, smi: str, k10_ms: float) -> dict:
    """28. The parallel layer on the card at world size 1 (one H100: NCCL
    takes one rank per card, so the multi-rank numbers are held on the CPU,
    tests/test_torch_parallel*.py): (a) a 1-rank NCCL group through
    ``distributed_init_if_needed`` on a free loopback port; (b) LittleNet's
    make_train_step with the mesh (its collectives through NCCL) against
    the unsharded step from the same net at TrainConfig() (16 x 8 s), and
    both steps' ms; (c) the stateful DCCRN and FullSubNet steps (default
    configs, the same TrainConfig() batch) with the mesh against without,
    K9 / K11 launched in both; (d) cli/train --mesh against no --mesh, 2
    steps each; (e) batch_enhance --mesh --batch 8 against no --mesh, each
    stage 1 (K1 / K5 once a run); (f) ``lstm_scan_tp`` at ATT-CCRN's H =
    4096, B = 1, T = 513 on a 1-rank model axis (no collective: the dense
    scan) against the plain fp32 lstm_scan (K9's bar), its ms beside K10's
    and the plain scan's; (g) ``pipelined_scan`` of kalman_step against the
    sequential scan; (h) ``dryrun_multichip(1)``, one NCCL rank in a
    process of its own (K3 in it)."""
    import importlib.util

    import torch.distributed as dist

    from aec_tpu_torch.cli import batch_enhance
    from aec_tpu_torch.cli import train as train_cli
    from aec_tpu_torch.configs import KalmanConfig, TrainConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.kernels.gru import gru_backward, gru_recurrence
    from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward
    from aec_tpu_torch.kernels.nlms import nlms_cancel_fused_batched
    from aec_tpu_torch.linear.kalman import kalman_init, kalman_step
    from aec_tpu_torch.models.little_net import little_net_init, little_net_loss
    from aec_tpu_torch.models.tree_net import model_state
    from aec_tpu_torch.ops.lstm import lstm_init, lstm_scan
    from aec_tpu_torch.parallel.dryrun import dryrun_multichip, free_port
    from aec_tpu_torch.parallel.mesh import distributed_init_if_needed, make_mesh
    from aec_tpu_torch.parallel.seq_scan import pipelined_scan, scan
    from aec_tpu_torch.parallel.tp_lstm import lstm_scan_tp
    from aec_tpu_torch.pipeline import h5io
    from aec_tpu_torch.pipeline.audio_io import read_wav
    from aec_tpu_torch.train.generic import make_adapter
    from aec_tpu_torch.train.loop import make_optimizer, make_stateful_train_step, make_train_step
    from aec_tpu_torch.utils.weights import param_tree
    from benchmarks.scenes import make_scenes

    t_phase = time.perf_counter()
    out: dict = {}
    # (a) one NCCL rank
    up = distributed_init_if_needed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    check(up and dist.get_backend() == "nccl", "the 1-rank NCCL group did not come up")
    mesh = make_mesh()
    phase("parallel", f"a. distributed_init_if_needed: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}, mesh {mesh.shape}, device {mesh.device}")

    # (b) LittleNet's step with the mesh against without, TrainConfig() (16 x 8 s)
    cfg = TrainConfig()
    scenes = [sc for sd in (seed, seed + 1)
              for sc in make_scenes(np.random.default_rng(sd), n=N_TRAIN).values()]
    far, mic, near = (torch.from_numpy(np.stack([sc[i] for sc in scenes])).to(dev)
                      for i in range(3))
    erb = torch.as_tensor(erb_filterbank(), device=dev)

    def little(m):
        net = little_net_init(generator=torch.Generator().manual_seed(seed), device=dev)
        step = make_train_step(little_net_loss, make_optimizer(cfg, 1, net), m)
        loss, counts = drive((gru_recurrence, gru_backward),
                             lambda: float(step(mic, far, near, erb)))
        check(counts == [1, 1], f"b. LittleNet's step did not launch K8 and K8b once each "
              f"(mesh {m is not None}): {counts}")
        params = param_tree(net, lambda p: p.detach().clone())
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(mic, far, near, erb))
            times.append((time.perf_counter() - t0) * 1e3)
        return (loss, params), statistics.median(times)

    (plain, t_plain), (meshed, t_mesh), (again, _) = little(None), little(mesh), little(None)
    check_steps(f"b. LittleNet make_train_step, {cfg.batch_size} x {N_TRAIN}", meshed, plain,
                again, cfg.lr)
    phase("parallel", f"b. launches K8 / K8b a step [1, 1] with and without the mesh; step ms "
          f"(median of 3 after the first): unsharded {t_plain:.1f}, mesh "
          f"{t_mesh:.1f} (its gradients' all-reduce, one flat bucket, and the loss terms' "
          f"collectives through NCCL) [{smi}]")
    out["little_ms"] = {"unsharded": t_plain, "mesh": t_mesh}

    # (c) the stateful DCCRN and FullSubNet steps, default configs, TrainConfig()'s batch
    full = (mic, far, near, mic - near)
    torch.backends.cudnn.deterministic = True
    for name, kernel, want in (("dccrn", grouped_lstm_recurrence, 2),
                               ("fullsubnet", joint_recurrence, 1)):
        adapter = make_adapter(name)

        def loss_fn(p, s, *b):
            loss, new_state = adapter.loss(p, s, *b, True)
            return loss, {"state": new_state}

        def stateful(m):
            net = adapter.module(*adapter.init(generator=torch.Generator().manual_seed(seed),
                                               device=dev))
            step = make_stateful_train_step(loss_fn, make_optimizer(cfg, 1, net), m)
            (state, loss), n = drive((kernel, lstm_backward),
                                     lambda: step(model_state(net), *full))
            return (float(loss), param_tree(net, lambda p: p.detach().clone()), state), n

        (plain, n_plain), (meshed, n_mesh), (again, _) = (stateful(None), stateful(mesh),
                                                          stateful(None))
        phase("parallel", f"c. {name} stateful step, {cfg.batch_size} x {N_TRAIN}: launches of "
              f"its kernel and K9b unsharded {n_plain}, mesh {n_mesh} (want {[want, 2]})")
        check(n_plain == n_mesh == [want, 2], f"c. {name}'s step did not launch its kernels")
        check_steps(f"c. {name} make_stateful_train_step", meshed, plain, again, cfg.lr)
        out[f"{name}_mesh_launches"] = n_mesh[0]
        out[f"{name}_mesh_k9b_launches"] = n_mesh[1]
    torch.backends.cudnn.deterministic = False
    del full
    small = tuple(t[:4, :32000].contiguous() for t in (mic, far, near, mic - near))

    if "h5py" not in sys.modules and importlib.util.find_spec("h5py") is None:
        sys.modules["h5py"] = npz_h5py()
    with tempfile.TemporaryDirectory() as work:
        # (d) cli/train --mesh against no --mesh: 4 utterances x 2 s, 2 steps
        files = []
        for i in range(4):
            files.append(os.path.join(work, f"tr_{i}.ex"))
            h5io.write_utterance(files[-1], {
                "nearend_speech": small[2][i].cpu().numpy(), "nearend_mic": small[0][i].cpu().numpy(),
                "farend_speech": small[1][i].cpu().numpy(), "echo": small[3][i].cpu().numpy()})
        lst, cv = os.path.join(work, "tr_list.txt"), os.path.join(work, "cv.ex")
        h5io.write_filelist(lst, files)
        h5io.write_grouped(cv, [h5io.read_utterance(f) for f in files[:2]])
        rows = {}
        for tag, extra in (("plain", []), ("mesh", ["--mesh"])):
            ckpt = os.path.join(work, f"exp_{tag}")
            run_cli(train_cli.main, ["--tr_list", lst, "--cv_file", cv, "--ckpt_dir", ckpt,
                                     "--batch_size", "2", "--max_n_epochs", "1", "--device",
                                     str(dev), *extra])
            with open(os.path.join(ckpt, "metrics.jsonl")) as f:
                rows[tag] = json.loads(f.readline())
        losses = {k: (rows["plain"][k], rows["mesh"][k]) for k in ("tr_loss", "cv_loss")}
        rel = max(abs(a / b - 1.0) for a, b in losses.values())
        phase("parallel", f"d. cli/train 2 steps of batch 2, tr / cv loss without --mesh "
              f"{losses['tr_loss'][0]:.8f} / {losses['cv_loss'][0]:.8f}, with "
              f"{losses['tr_loss'][1]:.8f} / {losses['cv_loss'][1]:.8f} (rel {rel:.2e}, bar "
              f"{STEP_LOSS_TOL:g})")
        check(rel <= STEP_LOSS_TOL, "d. cli/train --mesh's losses are off the run without")

        # (e) batch_enhance --mesh --batch 8 against no --mesh, each stage 1
        test_ex, tt = os.path.join(work, "test.ex"), os.path.join(work, "tt_list.txt")
        h5io.write_grouped(test_ex, [{"nearend_speech": sc[2], "nearend_mic": sc[1],
                                      "farend_speech": sc[0], "echo": sc[1] - sc[2]}
                                     for sc in scenes[:8]])
        h5io.write_filelist(tt, [test_ex])
        for stage1, kernel in (("kalman", kalman_cancel_fused_batched),
                               ("nlms", nlms_cancel_fused_batched)):
            wavs, counts = {}, {}
            for tag, extra in (("plain", []), ("mesh", ["--mesh"])):
                out_dir = os.path.join(work, f"bulk_{stage1}_{tag}")
                _, (counts[tag],) = drive((kernel,), lambda: run_cli(batch_enhance.main, [
                    "--tt_list", tt, "--model_file", "checkpoints/little_net_robust.npz",
                    "--out_dir", out_dir, "--batch", "8", "--stage1", stage1, "--device",
                    str(dev), *extra]))
                wavs[tag] = [read_wav(os.path.join(out_dir, f"{k}_enhanced.wav"))[0]
                             for k in range(8)]
            same = all(np.array_equal(a, b) for a, b in zip(wavs["plain"], wavs["mesh"]))
            err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))
                      for a, b in zip(wavs["mesh"], wavs["plain"]))
            phase("parallel", f"e. batch_enhance --stage1 {stage1} --batch 8, 8 x {N_TRAIN}: "
                  f"launches unsharded {counts['plain']}, mesh {counts['mesh']}; wavs "
                  f"{'bit-equal' if same else f'max|d| {err:.2e} of scale'} (bar {K1_TOL:g})")
            check(counts["plain"] == counts["mesh"] == 1 and err <= K1_TOL,
                  f"e. batch_enhance --mesh --stage1 {stage1} is off the run without")
            out[f"{stage1}_mesh_launches"] = counts["mesh"]

    # (f) the TP scan at ATT-CCRN's bottleneck on a 1-rank model axis
    g = torch.Generator().manual_seed(seed)
    lp = lstm_init(4096, 4096, generator=g, device=dev)
    x = torch.randn(1, T_DCCRN, 4096, generator=g).to(dev)
    tp = make_mesh(1, 1)
    with torch.no_grad():
        ys_tp, (h_tp, c_tp) = lstm_scan_tp(lp, x, tp)
        ys, (h_d, c_d) = lstm_scan(lp, x)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in ((ys_tp, ys), (h_tp, h_d), (c_tp, c_d)))
        t_tp = time_ms(lambda: lstm_scan_tp(lp, x, tp), reps)
        t_plain = time_ms(lambda: lstm_scan(lp, x), reps)
    phase("parallel", f"f. lstm_scan_tp H = 4096, B = 1, T = {T_DCCRN}, D = 1 (no collective) vs "
          f"the plain fp32 lstm_scan: max|d| {err:.3e} (bar {K9_TOL:g}); {t_tp:.2f} ms (plain fp32 scan "
          f"{t_plain:.2f} ms, K10's int8 {k10_ms:.3f} ms) [{smi}]")
    check(err <= K9_TOL, "f. lstm_scan_tp disagrees with the dense scan")
    out["tp_lstm"] = {"ms": t_tp, "plain_ms": t_plain, "max_abs_err": err}
    del lp, x, ys_tp, ys

    # (g) the pipelined scan of kalman_step at D = 1
    kcfg = KalmanConfig()
    kx = torch.randn(2, 64, 2 * 257, generator=g).to(dev)
    kd = torch.randn(2, 64, HOP, generator=g).to(dev)

    def kstep(state, xd):
        return kalman_step(kcfg, state, xd[0], xd[1], block=HOP)

    with torch.no_grad():
        pys, _ = pipelined_scan(kstep, kalman_init(kcfg, 257, device=dev), (kx, kd), mesh)
        want = torch.stack([scan(kstep, kalman_init(kcfg, 257, device=dev), (a, b))[1]
                            for a, b in zip(kx, kd)])
        torch.cuda.synchronize()
    err = float((pys - want).abs().max() / want.abs().max())
    phase("parallel", f"g. pipelined_scan of kalman_step, 2 x 64 blocks, D = 1: max|d| {err:.3e} "
          f"of scale (bar 1e-4)")
    check(err <= 1e-4, "g. the pipelined scan disagrees with the sequential scan")

    # (h) the dry run: one NCCL rank in a process of its own
    t0 = time.perf_counter()
    (dry,) = dryrun_multichip(1, device="cuda", timeout=300)
    phase("parallel", f"h. dryrun_multichip(1): backend {dry['backend']} on {dry['device']}, "
          f"loss {dry['loss']:.6f}, dccrn loss {dry['dccrn_loss']:.6f}, TP LSTM max|d| "
          f"{dry['tp_lstm_err']:.2e}, K3 launches {dry['k3_launches']} ({time.perf_counter() - t0:.1f} s)")
    check(dry["backend"] == "nccl" and dry["k3_launches"] == 2 and dry["tp_lstm_err"] <= K9_TOL,
          "h. the dry run did not run its surfaces on the card")
    out["k3_dryrun_launches"] = dry["k3_launches"]
    dist.destroy_process_group()
    phase("parallel", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def examples_phase(dev, seed: int, reps: int, smi: str) -> dict:
    """29. The examples (``aec_tpu_torch/examples``) through their entry
    points: (a) ``train_synthetic.main`` at 64 scenes x 4 s, 6 steps of the
    default recipe (K1, K8 and K8b once a step; K1 and K8 twice an
    evaluation, at step 0, the last and the end), then 2 steps of
    ``--width 4``, ``--balance`` and ``--asym 3 --sisnr 0.2``; each
    checkpoint loads in ``cli/infer.load_params`` and runs through
    ``two_stage_cancel`` on the card; (b) the step split by the host clock
    after a synchronize (synthesis, stage 1, the loss's forward and
    backward, the update) and the device's busy share (torch.profiler); (c)
    on one set of draws, stage 1 against its plain version (K1's bar) and,
    fed the same linear output, each recipe's kernel step against the CPU
    route (the train-step bars); (d) ``demo_two_stage`` on the card (K6 +
    K2) against its CPU run within 0.1 dB; (e) ``serving_loop`` at 128
    sessions x 50 blocks (K3 a block) against ``serving_step_plain`` on the
    same blocks (K3's bar), block latency and the live ERLE."""
    from aec_tpu_torch.cli.infer import load_params
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.examples import demo_two_stage as demo
    from aec_tpu_torch.examples import serving_loop as sl
    from aec_tpu_torch.examples import train_synthetic as ts
    from aec_tpu_torch.kernels.gru import gru_backward, gru_recurrence
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
    )
    from aec_tpu_torch.kernels.serving import serving_erle, serving_step_fused, serving_step_plain
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused
    from aec_tpu_torch.models.little_net import little_net_init
    from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
    from aec_tpu_torch.train.loop import make_train_step

    t_phase = time.perf_counter()
    train_kernels = (kalman_cancel_fused_batched, gru_recurrence, gru_backward)
    kcfg, scfg = KalmanConfig(), StftConfig()
    n = int(EX_SECONDS * SR) // 256 * 256
    erb_d = torch.as_tensor(erb_filterbank(), device=dev)
    erb_c = torch.from_numpy(erb_filterbank())
    lr = 3e-3  # the script's default
    out = {}

    # (a) the entry point, each recipe, its checkpoint through two_stage_cancel
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    far, mic, near = ts.synthesize_scenes(ts.scene_draws(gen, 16, n), n)
    with tempfile.TemporaryDirectory() as d:
        for name, recipe in EX_RECIPES.items():
            steps = EX_STEPS if not recipe else EX_RECIPE_STEPS
            ck = os.path.join(d, "little_net.npz")
            argv = ["--steps", str(steps), "--batch", str(EX_BATCH), "--seconds", str(EX_SECONDS),
                    "--seed", str(seed), "--out", ck, "--device", "cuda", *recipe]
            t0 = time.perf_counter()
            _, counts = drive(train_kernels, lambda: ts.main(argv))
            wall = time.perf_counter() - t0
            evals = 3 if steps > 1 else 2  # step 0, the last step, the end
            want = [steps + 2 * evals, steps + 2 * evals, steps]
            with open(ck[:-4] + ".json") as f:
                info = json.load(f)
            net = load_params(ck, device=dev)
            width = int(recipe[1]) if recipe[:1] == ("--width",) else 1
            (res, k_two) = drive((kalman_cancel_fused_batched, little_net_apply_fused,
                                  gru_recurrence),
                                 lambda: two_stage_cancel(net, far, mic, erb_d)["wav"])
            ok = res.shape == mic.shape and bool(torch.isfinite(res).all()) and (
                net.hidden == 32 * width)
            phase("examples", f"train_synthetic {name} ({' '.join(recipe)}), {steps} steps at "
                  f"{EX_BATCH} x {n}: "
                  f"launches K1 / K8 / K8b {counts} (want {want}); report "
                  + ", ".join(f"{k} {v}" for k, v in info.items() if k != "steps")
                  + f"; {wall:.2f} s with the evaluations; the checkpoint through "
                  f"two_stage_cancel 16 x {n}: launches K1 / K2 / K8 {k_two}, finite {ok} "
                  f"[{smi}]")
            check(counts == want, f"train_synthetic {name} did not launch K1 / K8 / K8b {want}")
            check(all(np.isfinite(v) for v in info.values()), f"train_synthetic {name} report")
            # a width-1 net's stage 2 is K2 (K8 its phase B); a wider one's the
            # offline apply, its GRU on K8, as JAX routes wider checkpoints
            check(ok and k_two == ([1, 1, 1] if width == 1 else [1, 0, 1]),
                  f"train_synthetic {name}'s checkpoint on two_stage_cancel")
            out.setdefault("main_launches", {})[name] = counts

    # (b) the step split, the default recipe; its device busy share
    net = little_net_init(generator=torch.Generator().manual_seed(seed), device=dev)
    opt = ts.recipe_optimizer(net, lr, 1500)
    loss_fn = ts.recipe_loss()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    parts, step_counts = [], []

    def timed_step():
        marks = [time.perf_counter()]
        far, mic, near = ts.synthesize_scenes(ts.scene_draws(gen, EX_BATCH, n), n)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        lin = ts.linear_output(kcfg, far, mic, scfg)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        opt.adam.zero_grad(set_to_none=True)
        loss, _ = loss_fn(net, lin, far, near, erb_d, scfg, sqrt_eps=1e-12)
        loss.backward()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        opt.update()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])], float(loss.detach())

    for _ in range(reps + 1):
        torch.cuda.synchronize()
        (ms, loss), counts = drive(train_kernels, timed_step)
        check(np.isfinite(loss), "train_synthetic step loss")
        parts.append(ms)
        step_counts.append(counts)
    check(all(c == [1, 1, 1] for c in step_counts), f"a train_synthetic step did not launch K1, "
          f"K8 and K8b once each: {step_counts}")
    split = [statistics.median(p[i] for p in parts[1:]) for i in range(4)]
    step_ms = statistics.median(sum(p) for p in parts[1:])
    busy, top = step_profile(lambda: timed_step())
    xrt = EX_BATCH * n / SR / (step_ms / 1e3)
    phase("examples", f"train_synthetic step, {EX_BATCH} x {n} (median of {reps}, host clock): "
          f"{step_ms:.2f} ms = {xrt:.1f} audio s a wall s; synthesis {split[0]:.2f}, stage 1 "
          f"(K1) {split[1]:.2f}, loss forward + backward (K8, K8b) {split[2]:.2f}, update "
          f"{split[3]:.2f} ms; launches K1 / K8 / K8b a step {step_counts[0]}; device busy "
          f"{busy:.2f} ms of a step ({busy / step_ms:.0%}); top kernels "
          + "; ".join(f"{k} {v:.2f} ms x {c}" for k, v, c in top) + f" [{smi}]")
    out.update(step_ms=step_ms, split_ms=split, xrt=xrt, busy_ms=busy,
               step_launches=step_counts[0])

    # (c) on one set of draws: stage 1 against its plain version, then each
    #     recipe's kernel step against the CPU route fed the same linear output
    far, mic, near = ts.synthesize_scenes(ts.scene_draws(gen, EX_BATCH, n), n)
    with torch.no_grad():
        lin, k1_count = drive((kalman_cancel_fused_batched,),
                              lambda: ts.linear_output(kcfg, far, mic, scfg))
        lin_p = kalman_cancel_plain(kcfg, far, mic, block=scfg.hop)["wav"]
    scale = float(mic.abs().max())
    k1_err = float((lin - lin_p).abs().max())
    phase("examples", f"stage 1 on {EX_BATCH} x {n} scenes: launches K1 {k1_count}; max|d| from "
          f"the plain version {k1_err:.3e} (bar {K1_TOL:g} x max|mic| = {K1_TOL * scale:.3e})")
    check(k1_count == [1] and k1_err <= K1_TOL * scale, "train_synthetic's stage 1 disagrees "
          "with its plain version")
    far_c, near_c, lin_c = far.cpu(), near.cpu(), lin.cpu()
    for name, recipe in EX_RECIPES.items():
        flags = dict(zip(recipe[::2], recipe[1::2])) if "--balance" not in recipe else {}
        width = int(flags.get("--width", 1))
        loss_fn = ts.recipe_loss("--balance" in recipe, float(flags.get("--asym", 0.0)),
                                 float(flags.get("--sisnr", 0.0)))
        nets = [little_net_init(width=width, generator=torch.Generator().manual_seed(seed),
                                device=where) for where in (dev, "cpu")]
        steps = [make_train_step(loss_fn, ts.recipe_optimizer(m, lr, 1500), scfg=scfg)
                 for m in nets]
        loss_k, counts = drive(train_kernels[1:], lambda: float(steps[0](lin, far, near, erb_d)))
        loss_c = float(steps[1](lin_c, far_c, near_c, erb_c))
        rel = abs(loss_k / loss_c - 1.0)
        mean_d = max(float((p.detach().cpu() - q.detach()).abs().mean())
                     for p, q in zip(nets[0].parameters(), nets[1].parameters()))
        phase("examples", f"step {name} on the same linear output: launches K8 / K8b {counts}; "
              f"loss {loss_k:.6f} (CPU route {loss_c:.6f}, rel {rel:.2e}, bar {STEP_LOSS_TOL:g}); "
              f"worst leaf mean|d| after the update {mean_d:.3e} (bar {STEP_PARAM_TOL:g} x lr = "
              f"{STEP_PARAM_TOL * lr:.1e})")
        check(counts == [1, 1], f"the {name} step did not launch K8 and K8b once")
        check(rel <= STEP_LOSS_TOL and mean_d <= STEP_PARAM_TOL * lr,
              f"the {name} step disagrees with the CPU route")
    out["k1_err"] = k1_err

    # (d) demo_two_stage: one utterance through K6 + K2, against its CPU run
    model = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                         "little_net_synthetic.npz")
    scene = demo.make_scene(DEMO_SECONDS)
    (rep, _), demo_counts = drive((kalman_cancel_fused, little_net_apply_fused),
                                  lambda: demo.run_demo(load_params(model, device=dev), scene,
                                                        DEMO_SECONDS, dev))
    rep_c, _ = demo.run_demo(load_params(model, device="cpu"), scene, DEMO_SECONDS, "cpu")
    worst = max(abs(rep[k] - rep_c[k]) for k in rep if k != "xrt")
    phase("examples", f"demo_two_stage {DEMO_SECONDS:g} s: launches K6 / K2 {demo_counts}; card "
          f"{rep}; CPU {rep_c}; worst |card - CPU| {worst:.2f} dB (bar {ERLE_TOL_DB} dB); xrt "
          f"{rep['xrt']} [{smi}]")
    check(demo_counts == [5, 5], "demo_two_stage did not run K6 and K2 on each of its 5 calls")
    check(worst <= ERLE_TOL_DB, "demo_two_stage on the card disagrees with its CPU run")
    out.update(demo_launches=demo_counts, demo_xrt=rep["xrt"])

    # (e) serving_loop: K3 a block, against serving_step_plain on the same blocks
    net = sl.load_net(dev)
    far, mic = sl.make_sessions(SERVE_STREAMS, SERVE_BLOCKS)
    (o_k, lat, st), k3_counts = drive((serving_step_fused,), lambda: sl.serve(net, far, mic, dev))
    o_p, _, _ = sl.serve(net, far, mic, dev, step=serving_step_plain)
    rel = max(float(np.abs(o_k[:, b:b + HOP] - o_p[:, b:b + HOP]).max())
              / max(float(np.abs(o_p[:, b:b + HOP]).max()), 1e-9)
              for b in range(0, o_p.shape[-1] - HOP, HOP))
    lat_ms = np.asarray(lat[1:]) * 1e3
    live = serving_erle(st).cpu().numpy()
    half = mic.shape[-1] // 2
    tail = 10 * np.log10((mic[:, half:] ** 2).mean() / max((o_k[:, half:] ** 2).mean(), 1e-12))
    p50, p99 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))
    phase("examples", f"serving_loop {SERVE_STREAMS} sessions x {SERVE_BLOCKS} blocks: launches "
          f"K3 {k3_counts}; worst block max|d| / scale from serving_step_plain {rel:.3e} (bar "
          f"{K3_TOL:g}); block latency p50 {p50:.3f} ms / p99 {p99:.3f} ms; tail ERLE "
          f"{tail:.1f} dB; live ERLE min {live.min():.1f} / median {np.median(live):.1f} / max "
          f"{live.max():.1f} dB [{smi}]")
    check(k3_counts == [SERVE_BLOCKS], "serving_loop did not run K3 once a block")
    check(rel <= K3_TOL and bool(np.isfinite(live).all()), "serving_loop disagrees with "
          "serving_step_plain")
    out.update(k3_launches=k3_counts[0], serve_p50_ms=p50, serve_p99_ms=p99)
    phase("examples", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def examples_extras(extra: dict, ex: dict) -> None:
    """Phase 29's launches into the kernels line's rows, as
    ``examples_launches``: K1's, K8's and K8b's in a train_synthetic step
    and in each recipe's run of its ``main`` (steps and evaluations), K6's
    and K2's in the demo, K3's in the serving loop."""
    for kernel, i in (("kalman_batched", 0), ("gru_scan", 1), ("gru_backward", 2)):
        extra.setdefault(kernel, {})["examples_launches"] = {
            "train_synthetic_step": ex["step_launches"][i],
            **{f"train_synthetic_{k}": v[i] for k, v in ex["main_launches"].items()}}
    for kernel, launches in (("kalman_single", {"demo_two_stage": ex["demo_launches"][0]}),
                             ("stage2", {"demo_two_stage": ex["demo_launches"][1]}),
                             ("serving", {"serving_loop": ex["k3_launches"]})):
        extra.setdefault(kernel, {})["examples_launches"] = launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. a CUDA device, or nothing
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
    from aec_tpu_torch.dsp.erb import erb_filterbank
    from aec_tpu_torch.kernels import (
        _build,
        fsn_costs,
        gru_wide_costs,
        lstm_bwd_costs,
        lstm_costs,
        single_costs,
    )
    from aec_tpu_torch.kernels.kalman import (
        kalman_cancel_fused,
        kalman_cancel_fused_batched,
        kalman_cancel_plain,
        kalman_filter_fused_batched,
        kalman_filter_fused_batched_plain,
    )
    from aec_tpu_torch.linear import overlap_save as ols
    from aec_tpu_torch.kernels.nlms import (
        nlms_cancel_fused,
        nlms_cancel_fused_batched,
        nlms_cancel_plain,
    )
    from aec_tpu_torch.kernels.gru import gru_recurrence
    from aec_tpu_torch.kernels.stage2 import (
        little_net_apply_fused,
        little_net_apply_fused_plain,
    )
    from aec_tpu_torch.kernels.serving import (
        serving_init,
        serving_state_to_stream,
        serving_step_fused,
        serving_step_plain,
    )
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
    from aec_tpu_torch.pipeline.streaming import stream_flush
    from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
    from aec_tpu_torch.utils.weights import load_npz
    from benchmarks.scenes import erle_tail, make_scenes

    # plain versions compute in full fp32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. the card and its power limit, as nvidia-smi gives them
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 3. build the kernels from the checkout's sources (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    cost_builds = lstm_costs.start_build()  # K9 and K10 whole and without their dots
    single_builds = single_costs.start_build()  # K6 / K7 whole and without transforms
    fsn_builds = fsn_costs.start_build()  # K11 whole, its producer alone, its consumers alone
    bwd_builds = lstm_bwd_costs.start_build()  # K9b whole and with each part of its step cut
    wide_builds = gru_wide_costs.start_build()  # K8 / K8b wide, whole and without their dots
    logs = _build.build("kalman_batched", "stage2", "serving", "two_stage", "nlms_batched",
                        "single_stream", "gru", "gru_wide", "lstm", "fullsubnet", "lstm_int8",
                        "lstm_bwd")
    cost_libs = lstm_costs.finish_build(cost_builds)
    single_libs = single_costs.finish_build(single_builds)
    fsn_libs = fsn_costs.finish_build(fsn_builds)
    bwd_libs = lstm_bwd_costs.finish_build(bwd_builds)
    wide_libs = gru_wide_costs.finish_build(wide_builds)
    build_s = time.perf_counter() - t0
    phase("build", f"{build_s:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                phase("build", f"{src}: {line.strip()}")
    K8_REGS.update(k8_registers(logs.get("gru", "")))
    for plan, regs in K8_REGS.items():
        phase("build", f"{plan}: {regs}")

    cfg = KalmanConfig()
    net = load_npz("checkpoints/little_net_robust.npz", device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    erb_terms = int((erb != 0).sum())  # the ERB matrix's support: K2's bound counts its terms

    # 4. each kernel vs its plain version at the main path's full shape
    far, mic = make_batch(dev, args.seed, BATCH, N)
    with torch.no_grad():
        e_k = kalman_cancel_fused_batched(cfg, far, mic)["wav"]
        e_p = kalman_cancel_plain(cfg, far, mic)["wav"]
        torch.cuda.synchronize()
        mic_scale = float(mic.abs().max())
        k1_err = float((e_k - e_p).abs().max())
        check(e_k.shape == mic.shape and bool(torch.isfinite(e_k).all()), "K1 output")
        phase("K1 vs plain", f"max|d| = {k1_err:.3e}, bar {K1_TOL:g} x max|mic| = "
              f"{K1_TOL * mic_scale:.3e}")
        check(k1_err <= K1_TOL * mic_scale, "K1 disagrees with its plain version")

        lin_b, far_b = e_p.reshape(BATCH, -1, 256), far.reshape(BATCH, -1, 256)
        o_k, m_k = little_net_apply_fused(net, lin_b, far_b, erb)
        o_p, m_p = little_net_apply_fused_plain(net, lin_b, far_b, erb)
        torch.cuda.synchronize()
        wav_scale = float(o_p.abs().max())
        k2_err = float((o_k - o_p).abs().max())
        k2_mask_err = float((m_k - m_p).abs().max())
        check(bool(torch.isfinite(o_k).all()) and m_k.shape == (BATCH, N // 256 + 1, 32),
              "K2 output")
        phase("K2 vs plain", f"wav max|d| = {k2_err:.3e} (bar {K2_WAV_TOL * wav_scale:.3e}), "
              f"mask max|d| = {k2_mask_err:.3e} (bar {K2_MASK_TOL:g})")
        check(k2_err <= K2_WAV_TOL * wav_scale, "K2 wav disagrees with its plain version")
        check(k2_mask_err <= K2_MASK_TOL, "K2 mask disagrees with its plain version")
        # as a batch of one (shorter runs of frames per CTA: other seams)
        o_1, m_1 = little_net_apply_fused(net, lin_b[:1], far_b[:1], erb)
        torch.cuda.synchronize()
        k2_b1_err = float((o_1 - o_p[:1]).abs().max())
        k2_b1_mask = float((m_1 - m_p[:1]).abs().max())
        phase("K2 vs plain", f"as a batch of one: wav max|d| = {k2_b1_err:.3e}, mask max|d| = "
              f"{k2_b1_mask:.3e} (the same bars)")
        check(k2_b1_err <= K2_WAV_TOL * wav_scale and k2_b1_mask <= K2_MASK_TOL,
              "K2 as a batch of one disagrees with its plain version")
        del o_k, o_p, m_k, m_p, o_1, m_1
        r = k2_against_fp64(net, lin_b, far_b, erb)
        phase("K2 round-off", f"main path: mask max|d| from fp64: K2 {r['K2']:.3e} (bar "
              f"{K2_MASK_TOL:g}), plain fp32 {r['plain']:.3e}, TF32 products {r['tf32']:.3e} "
              f"(control, >= {K2_CONTROL_MIN:g})")
        check(r["K2"] <= K2_MASK_TOL, "K2's mask is off its fp64 evaluation")
        check(r["tf32"] >= K2_CONTROL_MIN, "the TF32 control sits within the mask bar")
    del e_k, e_p
    k2_roundoff_phase(dev, args.seed)

    # 5. the main path end to end on the 8 scenes, kernel route vs plain route
    scenes = make_scenes(np.random.default_rng(args.seed), n=N)
    names = list(scenes)
    s_far = np.stack([scenes[k][0] for k in names])
    s_mic = np.stack([scenes[k][1] for k in names])
    sf, sm = torch.from_numpy(s_far).to(dev), torch.from_numpy(s_mic).to(dev)
    steps_before = dict(kalman_cancel_fused_batched.steps)
    tr_before = dict(little_net_apply_fused.transforms)
    out, launches = drive((kalman_cancel_fused_batched, little_net_apply_fused, gru_recurrence),
                          lambda: two_stage_cancel(net, sf, sm, erb))
    k1_steps = {k: v - steps_before[k] for k, v in kalman_cancel_fused_batched.steps.items()}
    k2_tr = {k: v - tr_before[k] for k, v in little_net_apply_fused.transforms.items()}
    phase("main path", f"two_stage_cancel 8 x {N}: launches K1 {launches[0]} (steps {k1_steps}), "
          f"K2 {launches[1]} (transforms {k2_tr}), K8 {launches[2]} (K2's phase B)")
    check(all(n > 0 for n in launches), "the main path did not go through every kernel")
    check(k1_steps == {"fft": launches[0], "dense": 0}, "K1 did not run its FFT step")
    check(k2_tr == {"fft": launches[1], "dense": 0} and launches[2] == launches[1],
          "K2 did not run its FFT phases with one K8 launch each")
    out = {k: v.cpu().numpy() for k, v in out.items()}
    check(out["wav"].shape == s_mic.shape and np.isfinite(out["wav"]).all(), "two_stage output")
    plain_ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz", device="cpu"),
                                 torch.from_numpy(s_far), torch.from_numpy(s_mic), erb_filterbank())
    with open("benchmarks/results/checkpoint_quality_r3.json") as f:
        jax_grades = json.load(f)["robust"]
    phase("scenes", "tail ERLE dB: stage1 kernel/plain, two-stage kernel/plain | JAX grade "
          "(robust, 4.1 s scenes, TPU v5e; information only)")
    worst = 0.0
    for i, k in enumerate(names):
        s1 = (erle_tail(s_mic[i], out["linear_wav"][i]),
              erle_tail(s_mic[i], plain_ref["linear_wav"][i].numpy()))
        s2 = erle_tail(s_mic[i], out["wav"][i]), erle_tail(s_mic[i], plain_ref["wav"][i].numpy())
        worst = max(worst, abs(s1[0] - s1[1]), abs(s2[0] - s2[1]))
        jg = jax_grades.get(k, {})
        phase("scenes", f"{k:13s} {s1[0]:8.3f} {s1[1]:8.3f} | {s2[0]:8.3f} {s2[1]:8.3f} | "
              f"JAX {jg.get('stage1_erle_db')} / {jg.get('two_stage_erle_db')}")
    phase("scenes", f"worst |kernel - plain| = {worst:.4f} dB (bar {ERLE_TOL_DB} dB)")
    check(worst <= ERLE_TOL_DB, "kernel route and plain route disagree in tail ERLE")

    # 6. times at the main path's shape (median of --reps, CUDA events); K1
    #    also as a batch of one 8.2 s utterance, as cli/infer runs it
    f1, m1 = far[:1], mic[:1]
    with torch.no_grad():
        t_k1 = time_ms(lambda: kalman_cancel_fused_batched(cfg, far, mic), args.reps)
        t_p1 = time_ms(lambda: kalman_cancel_plain(cfg, far, mic), args.reps)
        t_k1_b1 = time_ms(lambda: kalman_cancel_fused_batched(cfg, f1, m1), args.reps)
        t_p1_b1 = time_ms(lambda: kalman_cancel_plain(cfg, f1, m1), args.reps)
        t_k2 = time_ms(lambda: little_net_apply_fused(net, lin_b, far_b, erb), args.reps)
        t_p2 = time_ms(lambda: little_net_apply_fused_plain(net, lin_b, far_b, erb), args.reps)
        t_k2_b1 = time_ms(lambda: little_net_apply_fused(net, lin_b[:1], far_b[:1], erb), args.reps)
        t_p2_b1 = time_ms(lambda: little_net_apply_fused_plain(net, lin_b[:1], far_b[:1], erb),
                          args.reps)
        t_all = time_ms(lambda: two_stage_cancel(net, far, mic, erb), args.reps)
    xrt = BATCH * N / SR / (t_all / 1e3)
    k1_bound = {b: stage1_bounds(b) for b in (BATCH, 1)}
    phase("time", f"K1 {t_k1:.2f} ms (plain {t_p1:.2f} ms); K2 {t_k2:.2f} ms (plain {t_p2:.2f} ms)")
    for b, t_k, t_p in ((BATCH, t_k1, t_p1), (1, t_k1_b1, t_p1_b1)):
        fft_b, dense_b = k1_bound[b]
        phase("time", f"K1 B = {b} x {N}: {t_k:.3f} ms (plain {t_p:.2f} ms); bound "
              f"{fft_b['bound_ms']:.5f} ms ({fft_b['bound_by']}: the FFT step's "
              f"{stage1_fft_flops()} flops a step); the dense DFT formulation of the TPU "
              f"kernel, {2 * STAGE1_FMA} flops a step: {dense_b['bound_ms']:.4f} ms [{smi}]")
    k2_bound = {b: stage2_bounds(b, N, erb_terms) for b in (BATCH, 1)}
    for b, t_k, t_p in ((BATCH, t_k2, t_p2), (1, t_k2_b1, t_p2_b1)):
        fft_b, dense_b = k2_bound[b]
        phase("time", f"K2 B = {b} x {N}: {t_k:.3f} ms (plain {t_p:.2f} ms); bound "
              f"{fft_b['bound_ms']:.5f} ms ({fft_b['bound_by']}: the FFT formulation's "
              f"{stage2_fft_flops(erb_terms=erb_terms)} flops a frame, the ERB matrix's "
              f"{erb_terms} nonzero weights); the dense DFT formulation of the TPU kernel, "
              f"{2 * STAGE2_FMA} flops a frame: {dense_b['bound_ms']:.4f} ms [{smi}]")
    phase("time", f"two_stage_cancel {BATCH} x {N}: {t_all:.2f} ms = {xrt:.1f} x realtime "
          f"[{smi}]")
    print(f"two_stage_ms={t_all:.3f} xrt={xrt:.1f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)

    # 7. K4 vs K1 and K2 (stage 2 on K4's own stage-1 output) and vs its
    #    plain composition at the full shape; then the fast route
    from aec_tpu_torch.kernels.stage2 import little_net_apply_fused_wav

    k4_steps = dict(two_stage_fused.steps)
    with torch.no_grad():
        f_k = two_stage_fused(net, far, mic, erb)
        k4_steps = {k: v - k4_steps[k] for k, v in two_stage_fused.steps.items()}
        f_c = little_net_apply_fused_wav(net, f_k["linear_wav"], far, erb, normalize=False)
        f_c["linear_wav"] = kalman_cancel_fused_batched(cfg, far, mic)["wav"]
        f_p = two_stage_fused_plain(net, far, mic, erb)
        torch.cuda.synchronize()
    check(f_k["wav"].shape == mic.shape and bool(torch.isfinite(f_k["wav"]).all())
          and f_k["mask"].shape == (BATCH, N // HOP + 1, 32), "K4 output")
    phase("K4", f"{BATCH} x {N}: steps {k4_steps}")
    check(k4_steps == {"fft": 1, "dense": 0}, "K4 did not run its FFT hop")
    k4_scale = float(f_p["wav"].abs().max())
    for ref, label, bars in (
        (f_c, "K4 vs K1, K2", (K1_TOL * mic_scale, K2_WAV_TOL * k4_scale, K2_MASK_TOL)),
        (f_p, "K4 vs plain", (K1_TOL * mic_scale, K4_WAV_TOL * k4_scale, K4_MASK_TOL)),
    ):
        errs = [float((f_k[key] - ref[key]).abs().max()) for key in ("linear_wav", "wav", "mask")]
        phase(label, ", ".join(f"{key} max|d| = {e:.3e} (bar {b:.3e})" for key, e, b in
                               zip(("linear_wav", "wav", "mask"), errs, bars)))
        check(all(e <= b for e, b in zip(errs, bars)), f"{label}: K4 disagrees")
    k4_err = errs[1]
    del f_k, f_c, f_p
    with torch.no_grad():  # K4 at batch 1 and 3 (CTAs that do not fill the card)
        for b in (1, 3):
            got = two_stage_fused(net, far[:b], mic[:b], erb)
            want = two_stage_fused_plain(net, far[:b], mic[:b], erb)
            bars = (K1_TOL * mic_scale, K4_WAV_TOL * float(want["wav"].abs().max()), K4_MASK_TOL)
            errs = [float((got[key] - want[key]).abs().max())
                    for key in ("linear_wav", "wav", "mask")]
            phase("K4 vs plain", f"batch {b}: " + ", ".join(
                f"{key} max|d| = {e:.3e} (bar {v:.3e})" for key, e, v in
                zip(("linear_wav", "wav", "mask"), errs, bars)))
            check(all(e <= v for e, v in zip(errs, bars)), f"K4 disagrees at batch {b}")
    fast, (k4_launches,) = drive((two_stage_fused,),
                                 lambda: two_stage_cancel(net, sf, sm, erb, quality="fast"))
    phase("fast path", f"two_stage_cancel(quality='fast') 8 x {N}: launches K4 {k4_launches}")
    check(k4_launches > 0, "the fast path did not go through K4")
    fast = {k: v.cpu().numpy() for k, v in fast.items()}
    worst = max(abs(erle_tail(s_mic[i], fast[key][i]) - erle_tail(s_mic[i], out[key][i]))
                for i in range(len(names)) for key in ("linear_wav", "wav"))
    phase("fast path", f"worst |fast - parity route| tail ERLE over the 8 scenes = {worst:.4f} dB "
          f"(bar {ERLE_TOL_DB} dB)")
    check(worst <= ERLE_TOL_DB, "the fast route and the parity route disagree in tail ERLE")

    # 8. K3 vs plain at S = 1024 live streams: 64 one-hop calls, one k = 4 call
    s_far_d, s_mic_d = make_batch(dev, args.seed + 1, S_SERVE, 68 * HOP)
    k3_steps = dict(serving_step_fused.steps)
    with torch.no_grad():
        ks, ps, k3_rel, k3_err = serve_pair(net, erb, s_far_d, s_mic_d, [1] * 64 + [4])
        torch.cuda.synchronize()
        k3_steps = {k: v - k3_steps[k] for k, v in serving_step_fused.steps.items()}
        check(k3_steps == {"fft": 65, "dense": 0}, f"K3 did not run its FFT hop: {k3_steps}")
        leaf, leaf_rel = state_err(ks, ps)
        phase("K3 vs plain", f"S = {S_SERVE}, 64 x k=1 + 1 x k=4: out max|d| / scale = "
              f"{k3_rel:.3e}, worst state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g})")
        check(k3_rel <= K3_TOL and leaf_rel <= K3_TOL, "K3 disagrees with its plain version")
        ks_n, ps_n, n_rel, _ = serve_pair(net, erb, s_far_d[:128], s_mic_d[:128], [1] * 8 + [3] * 4,
                                       normalize=True, gain_norm=True)
        torch.cuda.synchronize()
        leaf_n, leaf_n_rel = state_err(ks_n, ps_n)
        phase("K3 vs plain", f"S = 128, normalize + gain_norm, 8 x k=1 + 4 x k=3: out "
              f"{n_rel:.3e}, worst state leaf {leaf_n} {leaf_n_rel:.3e} (bar {K3_TOL:g})")
        check(n_rel <= K3_TOL and leaf_n_rel <= K3_TOL,
              "K3 (normalize, gain_norm) disagrees with its plain version")
        for stage1 in ("kalman", "nlms"):  # a stream alone and the scenes' 8, both options
            for s in (1, 8):
                ks_s, ps_s, s_rel, _ = serve_pair(net, erb, s_far_d[:s], s_mic_d[:s],
                                                  [1] * 6 + [4] * 3, stage1=stage1,
                                                  normalize=True, gain_norm=True)
                leaf_s, leaf_s_rel = state_err(ks_s, ps_s)
                phase("K3 vs plain", f"{stage1}, S = {s}, normalize + gain_norm, 6 x k=1 + "
                      f"3 x k=4: out {s_rel:.3e}, worst state leaf {leaf_s} {leaf_s_rel:.3e} "
                      f"(bar {K3_TOL:g})")
                check(s_rel <= K3_TOL and leaf_s_rel <= K3_TOL,
                      f"K3-{stage1} disagrees with its plain version at S = {s}")
        cache_phase(net, erb, s_far_d, s_mic_d)

    # 9. the serving path: the 8 scenes streamed hop by hop through K3, then
    #     serving_state_to_stream + stream_flush, against offline two_stage_cancel
    def stream_scenes(stage1):
        st, blocks = serving_init(len(names), stage1=stage1, device=dev), []
        for lo in range(0, N, HOP):
            st, o = serving_step_fused(net, st, sf[:, lo : lo + HOP].contiguous(),
                                       sm[:, lo : lo + HOP].contiguous(), erb, stage1=stage1)
            blocks.append(o)
        blocks.append(stream_flush(net, serving_state_to_stream(st, stage1=stage1), erb))
        return torch.cat(blocks, -1)[:, HOP:].cpu().numpy()

    with torch.no_grad():
        streamed, (k3_launches,) = drive((serving_step_fused,), lambda: stream_scenes("kalman"))
    phase("serving path", f"8 scenes x {N // HOP} hops through serving_step_fused: launches K3 "
          f"{k3_launches}")
    check(k3_launches > 0, "the serving path did not go through K3")
    check(streamed.shape == s_mic.shape and np.isfinite(streamed).all(), "streamed output")
    s_rel = float(np.max(np.abs(streamed - out["wav"]))) / float(np.max(np.abs(out["wav"])))
    s_db = max(abs(erle_tail(s_mic[i], streamed[i]) - erle_tail(s_mic[i], out["wav"][i]))
               for i in range(len(names)))
    phase("serving path", f"streamed vs offline: max|d| / scale = {s_rel:.3e} (bar {STREAM_TOL:g}), "
          f"worst tail ERLE |d| = {s_db:.4f} dB (bar {ERLE_TOL_DB} dB)")
    check(s_rel <= STREAM_TOL and s_db <= ERLE_TOL_DB, "streamed output disagrees with offline")

    # 10. times of K3 and K4 (median of --reps, CUDA events). K3 per one-hop
    #     call at the streamed scenes' shape (8 streams, where its launches
    #     come from) and at S = 1024, per filter: the call with the card idle
    #     before it, and the kernel's device time (torch.profiler)
    from aec_tpu_torch.kernels import serving_costs

    blk_f, blk_m = s_far_d[:, :HOP].contiguous(), s_mic_d[:, :HOP].contiguous()
    scene_f, scene_m = sf[:, :HOP].contiguous(), sm[:, :HOP].contiguous()
    k3_costs = {(stage1, s): serving_costs.costs(net, erb, s, stage1, 4 * args.reps)
                for stage1 in ("kalman", "nlms") for s in (len(names), S_SERVE)}
    with torch.no_grad():
        t_p3 = time_ms(lambda: serving_step_plain(net, ps, blk_f, blk_m, erb), args.reps)
        st8 = {k: serving_init(len(names), stage1=k, device=dev) for k in ("kalman", "nlms")}
        t_p3_8 = {k: time_ms(lambda: serving_step_plain(net, st8[k], scene_f, scene_m, erb,
                                                        stage1=k), args.reps) for k in st8}
        t_k4 = time_ms(lambda: two_stage_fused(net, far, mic, erb), args.reps)
        t_p4 = time_ms(lambda: two_stage_fused_plain(net, far, mic, erb), args.reps)
    t_k3 = k3_costs[("kalman", S_SERVE)]["call_ms"]
    streams = S_SERVE * (HOP / SR * 1e3) / t_k3
    state_bytes = {k: 4 * sum(v.numel() for v in serving_init(1, stage1=k, device=dev).values())
                   for k in ("kalman", "nlms")}
    for (stage1, s), c in k3_costs.items():
        fft_b, dense_b = serving_bounds(s, state_bytes[stage1], erb_terms)
        phase("time", f"K3-{stage1} S = {s}, k = 1: {c['call_ms']:.4f} ms per call, kernel "
              f"{c['kernel_ms']:.4f} ms (device time), host {100 * c['host_share']:.1f} % of the "
              f"call = {s * (HOP / SR * 1e3) / c['call_ms']:.0f} concurrent realtime streams; "
              f"bound {fft_b['bound_ms']:.5f} ms ({fft_b['bound_by']}: {hop_flops(erb_terms)} "
              f"flops a hop, {state_bytes[stage1]} B of state a stream each way); the dense "
              f"formulation: {dense_b['bound_ms']:.4f} ms [{smi}]")
    phase("time", f"K3 plain version per one-hop call: S = {S_SERVE} {t_p3:.3f} ms; S = "
          f"{len(names)} Kalman {t_p3_8['kalman']:.3f} ms, NLMS {t_p3_8['nlms']:.3f} ms [{smi}]")
    k4_bounds = two_stage_bounds(BATCH, erb_terms)
    phase("time", f"K4 {BATCH} x {N}: {t_k4:.2f} ms (composition two_stage_cancel {t_all:.2f} ms, "
          f"plain {t_p4:.2f} ms); bound {k4_bounds[0]['bound_ms']:.4f} ms "
          f"({k4_bounds[0]['bound_by']}: {hop_flops(erb_terms)} flops a hop); the dense "
          f"formulation: {k4_bounds[1]['bound_ms']:.3f} ms [{smi}]")
    print(f"serving_ms={t_k3:.4f} streams={streams:.0f} two_stage_fused_ms={t_k4:.3f}", flush=True)

    # 11. K5 vs its plain version at the main path's full shape, on its FFT step
    ncfg = NlmsConfig()
    was = dict(nlms_cancel_fused_batched.steps)
    with torch.no_grad():
        e_k = nlms_cancel_fused_batched(ncfg, far, mic)["wav"]
        e_p = nlms_cancel_plain(ncfg, far, mic)["wav"]
        torch.cuda.synchronize()
    k5_step = {k: v - was[k] for k, v in nlms_cancel_fused_batched.steps.items()}
    k5_err = float((e_k - e_p).abs().max())
    check(e_k.shape == mic.shape and bool(torch.isfinite(e_k).all()), "K5 output")
    phase("K5 vs plain", f"{BATCH} x {N}, NlmsConfig(): max|d| = {k5_err:.3e}, bar "
          f"{STAGE1_TOL:g} x max|mic| = {STAGE1_TOL * mic_scale:.3e}; steps {k5_step}")
    check(k5_err <= STAGE1_TOL * mic_scale, "K5 disagrees with its plain version")
    check(k5_step == {"fft": 1, "dense": 0}, "K5 did not run its FFT step")
    del e_k, e_p

    # 12. K6 and K7 vs plain on one 16 s utterance and a hop-fractional one,
    #     twice with other inputs (a race between the warps' phases would
    #     show as a small, input-dependent error); K6 also against K1 as a
    #     batch of one, the route it replaces; both on their FFT route
    single = {"K6": (kalman_cancel_fused, kalman_cancel_plain, cfg),
              "K7": (nlms_cancel_fused, nlms_cancel_plain, ncfg)}
    single_err = dict.fromkeys(single, 0.0)
    was = [dict(fused.steps) for fused, _, _ in single.values()]
    with torch.no_grad():
        for rep in range(2):
            for n in (N_UTT, N_FRAC):
                f1, m1 = (t[0] for t in make_batch(dev, args.seed + 10 + rep, 1, n))
                bar = STAGE1_TOL * float(m1.abs().max())
                for label, (fused, plain, c) in single.items():
                    got = fused(c, f1, m1)["wav"]
                    want = plain(c, f1, m1)["wav"]
                    torch.cuda.synchronize()
                    check(got.shape == (n,) and bool(torch.isfinite(got).all()), f"{label} output")
                    err = float((got - want).abs().max())
                    single_err[label] = max(single_err[label], err)
                    msg = f"n = {n}, inputs {rep}: max|d| = {err:.3e} (bar {bar:.3e})"
                    if label == "K6":
                        k1 = kalman_cancel_fused_batched(c, f1[None], m1[None])["wav"][0]
                        e1 = float((got - k1).abs().max())
                        msg += f"; vs K1 as a batch of one {e1:.3e}"
                        check(e1 <= bar, "K6 disagrees with K1 as a batch of one")
                    phase(f"{label} vs plain", msg)
                    check(err <= bar, f"{label} disagrees with its plain version")
    single_steps = [{k: v - w[k] for k, v in fused.steps.items()}
                    for (fused, _, _), w in zip(single.values(), was)]
    phase("single vs plain", f"steps K6 {single_steps[0]}, K7 {single_steps[1]}")
    check(all(st == {"fft": 4, "dense": 0} for st in single_steps),
          "K6 / K7 did not run their FFT route")

    # 13. the 8 scenes with stage1="nlms": batched (K5 + K2), one by one on
    #     the single-stream route (K7 + K2), against the plain route on the
    #     CPU; and the single-stream Kalman route (K6 + K2) against phase 5's
    #     plain route. Each route is one path: counts set to 0, driven, read.
    def one_by_one(**kw):
        outs = [two_stage_cancel(net, sf[i], sm[i], erb, **kw) for i in range(len(names))]
        return {key: torch.stack([o[key] for o in outs]) for key in ("wav", "linear_wav")}

    stage1_fns = (nlms_cancel_fused_batched, nlms_cancel_fused, kalman_cancel_fused)
    was = [dict(fn.steps) for fn in stage1_fns]
    with torch.no_grad():
        nl_out, (k5_launches, k2_nl) = drive(
            (nlms_cancel_fused_batched, little_net_apply_fused),
            lambda: two_stage_cancel(net, sf, sm, erb, stage1="nlms"))
        nl_one, (k7_launches, k2_n1) = drive((nlms_cancel_fused, little_net_apply_fused),
                                             lambda: one_by_one(stage1="nlms"))
        ka_one, (k6_launches, k2_k1, k8_k1) = drive(
            (kalman_cancel_fused, little_net_apply_fused, gru_recurrence), lambda: one_by_one())
    route_steps = [{k: v - w[k] for k, v in fn.steps.items()} for fn, w in zip(stage1_fns, was)]
    phase("nlms path", f"two_stage_cancel(stage1='nlms') 8 x {N}: launches K5 {k5_launches}, "
          f"K2 {k2_nl}; one by one: launches K7 {k7_launches}, K2 {k2_n1}; steps K5 "
          f"{route_steps[0]}, K7 {route_steps[1]}")
    phase("single path", f"two_stage_cancel 8 x [{N}] one by one: launches K6 {k6_launches}, "
          f"K2 {k2_k1} (as a batch of one), K8 {k8_k1} (K2's phase B); steps K6 {route_steps[2]}")
    check(k8_k1 == k2_k1, "K2 as a batch of one did not run one K8 launch a call")
    check(all(st["dense"] == 0 and st["fft"] > 0 for st in route_steps),
          "K5, K6 or K7 did not run its FFT step on the scenes")
    check(min(k5_launches, k2_nl, k7_launches, k2_n1, k6_launches, k2_k1) > 0,
          "an NLMS or single-stream path did not go through its kernels")
    nl_ref = two_stage_cancel(load_npz("checkpoints/little_net_robust.npz", device="cpu"),
                              torch.from_numpy(s_far), torch.from_numpy(s_mic), erb_filterbank(),
                              stage1="nlms")
    routes = {"nlms batched": (nl_out, nl_ref), "nlms single": (nl_one, nl_ref),
              "kalman single": (ka_one, plain_ref)}
    phase("scenes", "tail ERLE dB, kernel route / plain route, stage 1 | two-stage")
    worst = dict.fromkeys(routes, 0.0)
    for i, k in enumerate(names):
        cells = []
        for route, (got, want) in routes.items():
            e = [(erle_tail(s_mic[i], got[key][i].cpu().numpy()),
                  erle_tail(s_mic[i], want[key][i].numpy())) for key in ("linear_wav", "wav")]
            worst[route] = max(worst[route], *(abs(a - b) for a, b in e))
            check(all(np.isfinite(v) for pair in e for v in pair), f"{route} ERLE on {k}")
            cells.append(f"{route} {e[0][0]:7.3f}/{e[0][1]:7.3f} | {e[1][0]:7.3f}/{e[1][1]:7.3f}")
        phase("scenes", f"{k:13s} " + "; ".join(cells))
    phase("scenes", "worst |kernel - plain| tail ERLE: " + ", ".join(
        f"{r} {w:.4f} dB" for r, w in worst.items()) + f" (bar {ERLE_TOL_DB} dB)")
    check(max(worst.values()) <= ERLE_TOL_DB, "an NLMS or single-stream route disagrees with plain")

    # 14. NLMS serving: the 8 scenes hop by hop through K3-NLMS + stream_flush
    #     against the offline NLMS route; then K3-NLMS vs plain at S = 1024
    with torch.no_grad():
        streamed_n, (k3n_launches,) = drive((serving_step_fused,), lambda: stream_scenes("nlms"))
    off_n = nl_out["wav"].cpu().numpy()
    check(k3n_launches > 0, "the NLMS serving path did not go through K3")
    check(streamed_n.shape == s_mic.shape and np.isfinite(streamed_n).all(), "NLMS streamed output")
    sn_rel = float(np.max(np.abs(streamed_n - off_n))) / float(np.max(np.abs(off_n)))
    sn_db = max(abs(erle_tail(s_mic[i], streamed_n[i]) - erle_tail(s_mic[i], off_n[i]))
                for i in range(len(names)))
    phase("nlms serving path", f"8 scenes x {N // HOP} hops: launches K3-NLMS {k3n_launches}; "
          f"streamed vs offline max|d| / scale = {sn_rel:.3e} (bar {STREAM_TOL:g}), worst tail "
          f"ERLE |d| = {sn_db:.4f} dB (bar {ERLE_TOL_DB} dB)")
    check(sn_rel <= STREAM_TOL and sn_db <= ERLE_TOL_DB, "NLMS streamed output disagrees with offline")
    k3n_steps = dict(serving_step_fused.steps)
    with torch.no_grad():
        ks_n, ps_n, k3n_rel, k3n_err = serve_pair(net, erb, s_far_d, s_mic_d, [1] * 64 + [4],
                                                  stage1="nlms")
        torch.cuda.synchronize()
    k3n_steps = {k: v - k3n_steps[k] for k, v in serving_step_fused.steps.items()}
    check(k3n_steps == {"fft": 65, "dense": 0}, f"K3-NLMS did not run its FFT hop: {k3n_steps}")
    leaf, leaf_rel = state_err(ks_n, ps_n)
    phase("K3-NLMS vs plain", f"S = {S_SERVE}, 64 x k=1 + 1 x k=4: out max|d| / scale = "
          f"{k3n_rel:.3e}, worst state leaf {leaf} {leaf_rel:.3e} (bar {K3_TOL:g})")
    check(k3n_rel <= K3_TOL and leaf_rel <= K3_TOL, "K3-NLMS disagrees with its plain version")

    # 15. times of K5 (in turns with K1: K1, K5, K5, K1), K6, K7 (also per
    #     step, whole and cut), the single-utterance paths and their stage 2
    #     alone, and K3-NLMS (median of --reps, CUDA events)
    f16, m16 = (t[0] for t in make_batch(dev, args.seed + 20, 1, N_UTT))
    utt_s = N_UTT / SR
    with torch.no_grad():
        turns = [time_ms(lambda: fn(c, far, mic), args.reps) for fn, c in (
            (kalman_cancel_fused_batched, cfg), (nlms_cancel_fused_batched, ncfg),
            (nlms_cancel_fused_batched, ncfg), (kalman_cancel_fused_batched, cfg))]
        t_k5 = statistics.median(turns[1:3])
        t_p5 = time_ms(lambda: nlms_cancel_plain(ncfg, far, mic), args.reps)
        t_k6 = time_ms(lambda: kalman_cancel_fused(cfg, f16, m16), args.reps)
        t_p6 = time_ms(lambda: kalman_cancel_plain(cfg, f16, m16), args.reps)
        t_k7 = time_ms(lambda: nlms_cancel_fused(ncfg, f16, m16), args.reps)
        t_p7 = time_ms(lambda: nlms_cancel_plain(ncfg, f16, m16), args.reps)
        t_k1_one = time_ms(lambda: kalman_cancel_fused_batched(cfg, f16[None], m16[None]),
                           args.reps)
        # K6, K7 at one 8.2 s scene, the shape of their launches on the scenes
        t_scene = {fn.__name__: (time_ms(lambda: fn(c, sf[0], sm[0]), args.reps),
                                 time_ms(lambda: plain(c, sf[0], sm[0]), args.reps))
                   for fn, plain, c in ((kalman_cancel_fused, kalman_cancel_plain, cfg),
                                        (nlms_cancel_fused, nlms_cancel_plain, ncfg))}
        lin16 = kalman_cancel_fused(cfg, f16, m16)["wav"].reshape(1, -1, HOP)
        t_k2_one = time_ms(lambda: little_net_apply_fused(net, lin16, f16.reshape(1, -1, HOP), erb),
                           args.reps)
        t_utt_k = time_ms(lambda: two_stage_cancel(net, f16, m16, erb), args.reps)
        t_utt_n = time_ms(lambda: two_stage_cancel(net, f16, m16, erb, stage1="nlms"), args.reps)
        # the batched NLMS route at the main shape: K5 + K2
        t_nlms_batch = time_ms(lambda: two_stage_cancel(net, far, mic, erb, stage1="nlms"),
                               args.reps)
        t_p3n = time_ms(lambda: serving_step_plain(net, ps_n, blk_f, blk_m, erb, stage1="nlms"),
                        args.reps)
    t_k3n = k3_costs[("nlms", S_SERVE)]["call_ms"]
    streams_n = S_SERVE * (HOP / SR * 1e3) / t_k3n
    k5_bounds = stage1_bounds(BATCH, nlms=True)
    k5_regs = lstm_costs.registers(logs.get("nlms_batched", ""), "nlms_batched_kernel", "FftStep",
                                   "FixedGeomILi256ELi10ELi32E")
    phase("time", f"two_stage_cancel(stage1='nlms') {BATCH} x {N} (K5 + K2): "
          f"{t_nlms_batch:.2f} ms = {BATCH * N / SR / (t_nlms_batch / 1e3):.1f} x realtime [{smi}]")
    phase("time", f"K5 {BATCH} x {N}: {t_k5:.2f} ms (plain {t_p5:.2f} ms); in turns K1 / K5 / K5 / "
          f"K1: {' / '.join(f'{t:.2f}' for t in turns)} ms; bound "
          f"{k5_bounds[0]['bound_ms']:.4f} ms ({k5_bounds[0]['bound_by']}: the FFT step's "
          f"{stage1_fft_flops(nlms=True)} flops a step); the dense DFT formulation: "
          f"{k5_bounds[1]['bound_ms']:.3f} ms; ptxas {k5_regs} [{smi}]")
    phase("time", f"one 16 s utterance: K6 {t_k6:.3f} ms (plain {t_p6:.2f} ms), K7 {t_k7:.3f} ms "
          f"(plain {t_p7:.2f} ms), one CTA each; K1 as a batch of one {t_k1_one:.2f} ms [{smi}]")
    k6_scene, k7_scene = t_scene["kalman_cancel_fused"], t_scene["nlms_cancel_fused"]
    k6_bounds, k7_bounds = stage1_bounds(1), stage1_bounds(1, nlms=True)
    phase("time", f"one 8.2 s scene: K6 {k6_scene[0]:.3f} ms (plain {k6_scene[1]:.2f} ms), K7 "
          f"{k7_scene[0]:.3f} ms (plain {k7_scene[1]:.2f} ms); bounds on the FFT formulation K6 "
          f"{k6_bounds[0]['bound_ms']:.5f} ms, K7 {k7_bounds[0]['bound_ms']:.5f} ms "
          f"({k6_bounds[0]['bound_by']}); the dense DFT formulation: "
          f"{k6_bounds[1]['bound_ms']:.4f} ms [{smi}]")
    with torch.no_grad():
        for row in single_costs.costs(single_libs, args.reps, args.seed):
            phase("time", f"{single_costs.report(row)} [{smi}]")
    k2_one_bound = stage2_bounds(1, N_UTT, erb_terms)
    phase("time", f"two_stage_cancel one 16 s utterance: Kalman {t_utt_k:.2f} ms = "
          f"{utt_s / (t_utt_k / 1e3):.1f} x realtime, NLMS {t_utt_n:.2f} ms = "
          f"{utt_s / (t_utt_n / 1e3):.1f} x realtime; its stage 2, K2 as a batch of one, "
          f"{t_k2_one:.3f} ms (bound {k2_one_bound[0]['bound_ms']:.5f} ms, "
          f"{k2_one_bound[0]['bound_by']}; dense formulation {k2_one_bound[1]['bound_ms']:.4f} "
          f"ms) [{smi}]")
    phase("time", f"K3-NLMS S = {S_SERVE}, k = 1: {t_k3n:.3f} ms per call (plain {t_p3n:.3f} ms) "
          f"= {streams_n:.0f} concurrent realtime streams [{smi}]")
    print(f"nlms_batched_ms={t_k5:.3f} kalman_single_ms={t_k6:.4f} nlms_single_ms={t_k7:.4f} "
          f"serving_nlms_ms={t_k3n:.4f} streams_nlms={streams_n:.0f}", flush=True)

    t_main = N // HOP
    # 16-18. K8 against its plain version and cuDNN; its gradients; the trainer
    gru = gru_phase(dev, args.seed, args.reps, smi, wide_libs)
    trained = trainer_phase(dev, args.seed, args.reps, smi)

    # 19. the wide-net single-utterance route: the width-4 checkpoint on the 8
    #     scenes one by one (stage 1 on K6, stage 2 offline with its GRU on
    #     K8 at H = 128) against the CPU route
    w4_path = "checkpoints/little_net_dtalk_w4.npz"
    w4 = load_npz(w4_path, device=dev)
    with torch.no_grad():
        w4_out, (k6_w4, k8_w4) = drive(
            (kalman_cancel_fused, gru_recurrence),
            lambda: [two_stage_cancel(w4, sf[i], sm[i], erb) for i in range(len(names))])
    w4_ref = two_stage_cancel(load_npz(w4_path, device="cpu"), torch.from_numpy(s_far),
                              torch.from_numpy(s_mic), erb_filterbank())
    w4_worst = 0.0
    for i, k in enumerate(names):
        got = [erle_tail(s_mic[i], w4_out[i][key].cpu().numpy()) for key in ("linear_wav", "wav")]
        want = [erle_tail(s_mic[i], w4_ref[key][i].numpy()) for key in ("linear_wav", "wav")]
        check(all(np.isfinite(got)), f"width-4 route ERLE on {k}")
        w4_worst = max(w4_worst, *(abs(a - b) for a, b in zip(got, want)))
        phase("wide net", f"{k:13s} stage 1 {got[0]:8.3f} / {want[0]:8.3f}, two-stage "
              f"{got[1]:8.3f} / {want[1]:8.3f} (card / CPU route)")
    with torch.no_grad():
        t_w4 = time_ms(lambda: two_stage_cancel(w4, sf[0], sm[0], erb), args.reps)
    phase("wide net", f"little_net_dtalk_w4 one by one, 8 x {N}: launches K6 {k6_w4}, K8 {k8_w4}; "
          f"worst |card - CPU| tail ERLE {w4_worst:.4f} dB (bar {ERLE_TOL_DB} dB); "
          f"{t_w4:.2f} ms per utterance [{smi}]")
    check(k6_w4 > 0 and k8_w4 > 0, "the wide-net route did not go through K6 and K8")
    check(w4_worst <= ERLE_TOL_DB, "the wide-net route disagrees with the CPU route")

    # 20. K12: the spectra-in entry at the main shape against K1 (the same
    #     step, analysis in the kernel) and its plain loop; then times, in
    #     turns with K1 (K1, K12, K12, K1)
    x_ri = ols.far_end_spectra(far, HOP).contiguous()
    d_blocks = mic.reshape(BATCH, -1, HOP)
    with torch.no_grad():
        e12, (k12_launches,) = drive((kalman_filter_fused_batched,),
                                     lambda: kalman_filter_fused_batched(cfg, x_ri, d_blocks))
        e1 = kalman_cancel_fused_batched(cfg, far, mic)["wav"].reshape(BATCH, -1, HOP)
        ep = kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks)
        torch.cuda.synchronize()
        k12_err = float((e12 - ep).abs().max())
        k12_k1 = float((e12 - e1).abs().max())
        check(e12.shape == d_blocks.shape and bool(torch.isfinite(e12).all()), "K12 output")
        phase("K12", f"{BATCH} x {t_main} blocks: launches {k12_launches}; max|d| vs K1 "
              f"{k12_k1:.3e}, vs plain {k12_err:.3e} (bar {K1_TOL:g} x max|mic| = "
              f"{K1_TOL * mic_scale:.3e})")
        check(k12_launches == 1 and max(k12_err, k12_k1) <= K1_TOL * mic_scale,
              "K12 disagrees with K1 or its plain version")
        k12_turns = [time_ms(lambda: fn(), args.reps) for fn in (
            lambda: kalman_cancel_fused_batched(cfg, far, mic),
            lambda: kalman_filter_fused_batched(cfg, x_ri, d_blocks),
            lambda: kalman_filter_fused_batched(cfg, x_ri, d_blocks),
            lambda: kalman_cancel_fused_batched(cfg, far, mic))]
        t_k12 = statistics.median(k12_turns[1:3])
        t_p12 = time_ms(lambda: kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks), args.reps)
    k12_fft, k12_dense = stage1_bounds(BATCH, analysis=False)
    phase("time", f"K12 {BATCH} x {N}: {t_k12:.2f} ms (plain {t_p12:.2f} ms); in turns K1 / K12 / "
          f"K12 / K1: {' / '.join(f'{t:.2f}' for t in k12_turns)} ms; bound "
          f"{k12_fft['bound_ms']:.5f} ms ({k12_fft['bound_by']}: the FFT step's "
          f"{stage1_fft_flops(analysis=False)} flops a step); the dense DFT formulation: "
          f"{k12_dense['bound_ms']:.4f} ms [{smi}]")
    del x_ri, d_blocks, e12, e1, ep

    # 21. the stage-1/2 kernels at other geometries and at their largest
    #     partition counts; 22-23. K9 and the DCCRN path
    geometry_phase(dev, net, names, s_far, s_mic, smi)
    k4_roundoff_phase(dev, net, args.seed)
    dense_step_phase(dev, net, s_far, s_mic)
    limits_phase(dev, net, args.seed, smi)
    with torch.no_grad():
        step_costs = lstm_costs.costs(cost_libs, args.reps, args.seed)
        bwd_costs = lstm_bwd_costs.costs(bwd_libs, args.reps, args.seed)
    lstm = lstm_phase(dev, args.seed, args.reps, smi, step_costs)
    lstm_train = lstm_train_phase(dev, args.seed, args.reps, smi, bwd_costs)
    dccrn = dccrn_phase(dev, names, s_far, s_mic, args.reps, smi)
    # 24-25. K11 and the FullSubNet path; K10 and the ATT-CCRN path
    with torch.no_grad():
        fsn_parts = fsn_costs.costs(fsn_libs, args.reps, args.seed)
    fsn = fullsubnet_phase(dev, names, s_far, s_mic, args.reps, smi, fsn_parts)
    fsn_train = fullsubnet_train_phase(dev, args.seed, args.reps, smi, bwd_costs)
    att = att_ccrn_phase(dev, names, s_far, s_mic, args.reps, smi, step_costs)
    # 26. zoo training: every cli/train family and the DCT nets at batch 16 x 8 s
    zoo = zoo_phase(dev, args.seed, args.reps, smi)
    # 27. the data pipeline and the CLIs
    data = data_phase(dev, args.seed, smi)
    # 28. the parallel layer at world size 1 on NCCL
    par = parallel_phase(dev, args.seed, args.reps, smi, att["ms"])
    # 29. the examples: train_synthetic, demo_two_stage, serving_loop
    ex = examples_phase(dev, args.seed, args.reps, smi)

    # 30. the kernels of the paths, with this run's numbers; bounds from
    #     this run's shapes (module top); library_ms where PyTorch calls
    #     compute the same function (cuDNN's GRU for K8, its LSTM for K9,
    #     its LSTM twice and the embedding for K11), else null (no PyTorch
    #     call computes K10's int8 recurrence)
    n_serve = len(names)  # K3's row: the streamed scenes' shape, where its launches come from
    k8 = gru["shapes"][(1, 1001, BANDS)]
    k8b = gru["shapes"][(16, 501, BANDS)]  # a LittleNet train step's GRU
    k8w = gru["shapes"][(16, 501, 512)]  # the DCT-CNN's train step's GRU
    k9 = lstm["shapes"][1]
    # K9 per layer at B = 1: 2 groups x 2 rows x 4H x H FMA per frame; xp in,
    # W_hh read, ys out
    k9_bound = bound(2 * 2 * 4 * 1024 * 1024 * T_DCCRN,
                     4 * (2 * 2 * T_DCCRN * 4 * 1024 + 2 * 4 * 1024 * 1024
                          + 2 * 2 * T_DCCRN * 1024))
    rows = [
        ("kalman_batched", "kalman_batched.cu", "pallas_kalman.py:492", launches[0], k1_err,
         t_k1, t_p1, k1_bound[BATCH][0]),
        ("stage2", "stage2.cu", "pallas_stage2.py:100", launches[1], k2_err, t_k2, t_p2,
         k2_bound[BATCH][0]),
        # K2 as a batch of one 8.2 s utterance; launches from the scenes one by one
        ("stage2_batch_of_one", "stage2.cu", "pallas_stage2.py:100", k2_k1, k2_b1_err, t_k2_b1,
         t_p2_b1, k2_bound[1][0]),
        # K3 per one-hop call on the 8 streamed scenes' streams (its kernel's
        # device time beside, as kernel_ms)
        ("serving", "serving.cu", "pallas_serving.py:239", k3_launches, k3_err,
         k3_costs[("kalman", n_serve)]["call_ms"], t_p3_8["kalman"],
         serving_bounds(n_serve, state_bytes["kalman"], erb_terms)[0]),
        ("serving_nlms", "serving.cu", "pallas_serving.py:239", k3n_launches, k3n_err,
         k3_costs[("nlms", n_serve)]["call_ms"], t_p3_8["nlms"],
         serving_bounds(n_serve, state_bytes["nlms"], erb_terms)[0]),
        ("two_stage", "two_stage.cu", "pallas_two_stage.py:134", k4_launches, k4_err, t_k4, t_p4,
         k4_bounds[0]),
        ("nlms_batched", "nlms_batched.cu", "pallas_nlms.py:242", k5_launches, k5_err, t_k5, t_p5,
         k5_bounds[0]),
        # K6, K7 per 8.2 s scene, the shape of their launches on the scenes
        ("kalman_single", "single_stream.cu", "pallas_kalman.py:150", k6_launches,
         single_err["K6"], *k6_scene, k6_bounds[0]),
        ("nlms_single", "single_stream.cu", "pallas_nlms.py:94", k7_launches, single_err["K7"],
         *k7_scene, k7_bounds[0]),
        # K8 at one 16 s utterance, H = 32; launches from the trainer's validation
        ("gru_scan", "gru.cu", "pallas_gru.py:65", trained["k8_val"], gru["err"], k8["ms"],
         k8["plain_ms"], gru_bound(1, 1001, BANDS)),
        # K8b at a LittleNet train step's GRU (B = 16, T = 501, H = 32) on
        # saved gates; launches from the trainer's 5 steps
        ("gru_backward", "gru.cu", "pallas_gru.py:159", trained["k8b_steps"], gru["bwd_err"],
         k8b["k8b_ms"], k8b["k8b_plain_ms"], k8b_bound(16, 501, BANDS)),
        # the wide path (H > 128) at the DCT-CNN's training shape (B = 16, T =
        # 501, H = 512; K8 saving the gates there in the route, timed here
        # without); launches from the zoo's DCT-CNN step
        ("gru_scan_wide", "gru_wide.cu", "pallas_gru.py:65", zoo["dct_cnn"]["wide_launches"][0],
         gru["wide_err"], k8w["ms"], k8w["plain_ms"], gru_bound(16, 501, 512)),
        ("gru_backward_wide", "gru_wide.cu", "pallas_gru.py:159",
         zoo["dct_cnn"]["wide_launches"][1], gru["wide_bwd_err"], k8w["k8b_ms"],
         k8w["k8b_plain_ms"], k8b_bound(16, 501, 512)),
        ("kalman_batched_spectra", "kalman_batched.cu", "pallas_kalman.py:303", k12_launches,
         k12_err, t_k12, t_p12, stage1_bounds(BATCH, analysis=False)[0]),
        # K9 at one 8.2 s utterance (B = 1, T = 513); launches from the DCCRN path
        ("lstm_grouped", "lstm.cu", "pallas_lstm.py:88", dccrn["k9_launches"], lstm["err"],
         k9["ms"], k9["plain_ms"], k9_bound),
        # K10 at ATT-CCRN's bottleneck (B = 1, T = 513, H = 4096); launches from its path
        ("lstm_int8", "lstm_int8.cu", "pallas_lstm.py:237", att["launches"], att["err"],
         att["ms"], att["plain_ms"], int8_bound(1, T_DCCRN, 4096)),
        # K11 at one 8.2 s utterance (B = 1, T = 820); launches from the FullSubNet path
        ("fullsubnet_joint", "fullsubnet.cu", "pallas_fullsubnet.py:106", fsn["launches"],
         fsn["err"], fsn["shapes"][1]["ms"], fsn["shapes"][1]["plain_ms"], fsn_bound(1, T_FSN)),
        # K9b at DCCRN's training shape (one layer: 2 groups x 32 rows x 501
        # steps, H = 1024) on saved gates; launches from the zoo's DCCRN and
        # FullSubNet first steps (two each)
        ("lstm_backward", "lstm_bwd.cu", "pallas_lstm.py:341",
         zoo["dccrn"]["step_launches"][4] + zoo["fullsubnet"]["step_launches"][4],
         max(lstm_train["k9b_err"], fsn_train["k9b_err"]), lstm_train["k9b_ms"],
         lstm_train["k9b_plain_ms"], lstm_train["k9b_bound"]),
    ]
    # cuDNN's nn.GRU and nn.LSTM with the kernels' weights
    library_ms = {"gru_scan": k8["library_ms"], "gru_backward": k8b["lib_bwd_ms"],
                  "gru_scan_wide": k8w["library_ms"], "gru_backward_wide": k8w["lib_bwd_ms"],
                  "lstm_grouped": k9["library_ms"],
                  "fullsubnet_joint": fsn["shapes"][1]["library_ms"],
                  "lstm_backward": lstm_train["lib_bwd_ms"]}
    # K3's kernel alone (torch.profiler device time), beside its call's ms;
    # K5, K6, K7: the dense formulation's bound beside the FFT one, and the
    # step that ran on their paths
    kernel_ms = {"serving": k3_costs[("kalman", n_serve)]["kernel_ms"],
                 "serving_nlms": k3_costs[("nlms", n_serve)]["kernel_ms"]}
    extra = {kernel: {"dense_bound_ms": b[1]["bound_ms"], "step": "fft"} for kernel, b in (
        ("nlms_batched", k5_bounds), ("kalman_single", k6_bounds), ("nlms_single", k7_bounds))}
    # K11: its producer alone and its consumers alone (fsn_costs), and B = 4
    k11_b4 = fsn["shapes"][4]
    extra["fullsubnet_joint"] = {
        "producer_ms": fsn["shapes"][1]["producer_ms"],
        "consumers_ms": fsn["shapes"][1]["consumers_ms"],
        "b4": {"ms": k11_b4["ms"], "plain_ms": k11_b4["plain_ms"],
               "library_ms": k11_b4["library_ms"], **fsn_bound(4, T_FSN)}}
    # the zoo's training launches: one batch-16 step and validation of 8
    # scenes at batch 1, per family whose path runs the kernel
    for kernel, i, family in (("gru_scan", 0, "two_layer_gru"), ("lstm_grouped", 1, "dccrn"),
                              ("fullsubnet_joint", 2, "fullsubnet")):
        extra.setdefault(kernel, {})["train_launches"] = {
            f"{family}_step": zoo[family]["step_launches"][i],
            f"{family}_validation": zoo[family]["validation_launches"][i]}
    # phase 27's paths: batch_enhance (a batch of 8), infer on the .pt (8
    # scenes one by one), the cached trainer's validation (8 scenes at batch
    # 1, two epochs)
    extra["kalman_batched"] = {"cli_launches": {
        "batch_enhance": data["kalman_bulk_launches"], "infer_pt": data["infer_pt_launches"][0]}}
    extra["nlms_batched"]["cli_launches"] = {"batch_enhance": data["nlms_bulk_launches"]}
    extra["gru_scan"]["cli_launches"] = {"cached_validation": data["k8_cached"],
                                         "infer_pt": data["infer_pt_launches"][1],
                                         "batch_enhance": data["k8_bulk_launches"]}
    # the batches users train and enhance at: the route's forward, and with
    # K8b its forward and backward, beside cuDNN's (phase 16)
    batched = {f"B{b}xT{t}xH{h}": {k: v for k, v in row.items() if k != "plain_ms"}
               for (b, t, h), row in gru["shapes"].items() if b > 1}
    extra["gru_scan"]["batched"] = batched
    extra["gru_backward"] = {
        "train_launches": {"little_net_steps": trained["k8b_steps"],
                           "two_layer_gru_step": zoo["two_layer_gru"]["step_launches"][3],
                           "cached_trainer": data["k8b_cached"]},
        "route_bwd_ms": k8b["route_bwd_ms"], "route_fwd_bwd_ms": k8b["route_fwd_bwd_ms"],
        "library_fwd_bwd_ms": k8b["lib_fwd_bwd_ms"],
        # B = 16 x 501 at H = 128 (gate n's tail chunks of W in shared
        # memory): K8b, cuDNN's backward alone, ptxas's line
        "h128": {k: gru["shapes"][(16, 501, 128)][k] for k in ("k8b_ms", "lib_bwd_ms")}
        | {**k8b_bound(16, 501, 128), "registers": k8b_h128_registers()}}
    # phase 28's mesh routes at world size 1: batch_enhance --mesh, the
    # stateful steps with the mesh, the dry run's serving step
    extra["kalman_batched"]["cli_launches"]["batch_enhance_mesh"] = par["kalman_mesh_launches"]
    extra["nlms_batched"]["cli_launches"]["batch_enhance_mesh"] = par["nlms_mesh_launches"]
    extra["lstm_grouped"]["train_launches"]["dccrn_mesh_step"] = par["dccrn_mesh_launches"]
    extra["fullsubnet_joint"]["train_launches"]["fullsubnet_mesh_step"] = \
        par["fullsubnet_mesh_launches"]
    # the training shapes (B = 16 x 8 s): each route's forward and backward
    # and its backward alone beside the library's (cuDNN's nn.LSTM for the
    # same function; for FullSubNet the two-scan composition)
    for kernel, row in (("lstm_grouped", lstm_train), ("fullsubnet_joint", fsn_train)):
        extra[kernel]["train"] = {k: row[k] for k in (
            "route_fwd_bwd_ms", "lib_fwd_bwd_ms", "route_bwd_ms", "lib_bwd_ms")}
    extra["lstm_backward"] = {
        "train_launches": {f"{fam}_step": zoo[fam]["step_launches"][4]
                           for fam in ("dccrn", "fullsubnet")}
        | {f"{fam}_validation": zoo[fam]["validation_launches"][4]
           for fam in ("dccrn", "fullsubnet")}
        | {f"{fam}_mesh_step": par[f"{fam}_mesh_k9b_launches"] for fam in ("dccrn", "fullsubnet")},
        "route_bwd_ms": lstm_train["route_bwd_ms"],
        # µs a step whole and with each part cut (kernels/lstm_bwd_costs.py)
        "split_us": {**lstm_train["k9b_split_us"], **fsn_train["k9b_split_us"]},
        "route_fwd_bwd_ms": lstm_train["route_fwd_bwd_ms"],
        "library_fwd_bwd_ms": lstm_train["lib_fwd_bwd_ms"],
        # FullSubNet's two passes at B = 16, T = 801
        **{f"fullsubnet_{band}": {"ms": fsn_train[f"k9b_{key}_ms"],
                                  "plain_ms": fsn_train[f"k9b_{key}_plain_ms"],
                                  **fsn_train[f"k9b_{key}_bound"]}
           for band, key in (("sub_band", "sb"), ("full_band", "fb"))}}
    extra.setdefault("serving", {})["dryrun_launches"] = par["k3_dryrun_launches"]
    # the wide path at B = 1 x 1001 (validation and inference), the route's
    # forward and backward beside cuDNN's at 16 x 501, the DCT-CNN's step,
    # and both kernels whole and without their dots (µs a step)
    wide_costs = {f"{r['kernel']} {r['shape']}": r["us_per_step"] for r in gru["wide_costs"]}
    extra["gru_scan_wide"] = {
        **{f"B1xT1001xH{h}": {k: gru["shapes"][(1, 1001, h)][k]
                              for k in ("ms", "plain_ms", "library_ms")} | gru_bound(1, 1001, h)
           for h in (129, 512)},
        "route_fwd_ms": k8w["route_fwd_ms"], "library_fwd_ms": k8w["lib_fwd_ms"],
        "train_launches": {"dct_cnn_step": zoo["dct_cnn"]["wide_launches"][0]},
        "dct_cnn_step_ms": zoo["dct_cnn"]["step_ms"], "us_per_step": wide_costs}
    extra["gru_backward_wide"] = {
        "route_bwd_ms": k8w["route_bwd_ms"], "route_fwd_bwd_ms": k8w["route_fwd_bwd_ms"],
        "library_fwd_bwd_ms": k8w["lib_fwd_bwd_ms"],
        "train_launches": {"dct_cnn_step": zoo["dct_cnn"]["wide_launches"][1]}}
    examples_extras(extra, ex)
    phase("total", f"{time.perf_counter() - t_start:.1f} s, the build's {build_s:.1f} s "
          f"included [{smi}]")
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda", "source": f"aec_tpu_torch/kernels/csrc/{src}",
         "replaces": f"aec_tpu/kernels/{tpu}", "launches": n, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, **bnd, "library_ms": library_ms.get(kernel),
         **({"kernel_ms": kernel_ms[kernel]} if kernel in kernel_ms else {}),
         **extra.get(kernel, {})}
        for kernel, src, tpu, n, err, ms, plain_ms, bnd in rows
    ]}), flush=True)
    # 31. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
