#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mimikit_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc``; it imports nothing of JAX or of ``mimikit_tpu``.

Phases (any failure exits non-zero; no exception is swallowed):

1. environment and build: the card's name and power limit, torch/CUDA
   versions; build ``csrc/samplernn_decode.cu``, ``csrc/samplernn_cluster.cu``,
   ``csrc/fused_lstm.cu``, ``csrc/wavenet_decode.cu``,
   ``csrc/wavenet_cluster.cu``, ``csrc/transformer_decode.cu``,
   ``csrc/transformer_kv.cu``, ``csrc/jukebox_decode.cu``,
   ``csrc/jukebox_cluster.cu``, ``csrc/jukebox_group.cu`` and
   ``csrc/categorical.cu`` for sm_90a, the eleven nvcc runs started
   together, and time them; the SASS digest of every kernel of those
   sources (``tools/sass_digest.py``) must equal ``tools/sass_digests.json``
   (the LSTM kernels', dWh's and K9's as the parent checkout left them, the
   decode kernels' as their per-row temperatures made them);
   compile the Triton mu-law kernel;
2. each kernel against its plain twin at a small size and at the main
   paths' widths.  ``decode_single`` and ``decode_chunk``, argmax and
   sampled (temperature 0.9): the kernel's tokens are verified by teacher
   forcing: fed back as the prompt of the plain PyTorch twin, every kernel
   token must score within 1e-4 * max|score| of its row's maximum, and the
   free-running plain tokens must equal the kernel's up to the first such
   near-tie; several chunk lengths and stream groupings must give identical
   tokens.  ``decode_single`` at full width through its route (K2's
   cluster kernel at B=4) and on the block kernel (``cl=0``), f32 and bf16.
   K2's cluster kernel (``csrc/samplernn_cluster.cu``, where
   ``K2_CLUSTER_ROUTE`` sends ``decode_chunk`` and ``decode_single``; the
   full-width B=256 checks run through it) the same way at a net it takes (``CLUSTER_MID``: B=4 and
   the ragged B=37, clusters of 8 and 16, f32 and bf16, the bf16 cases with
   the control below run through the cluster kernel) and at full width at
   B=37, f32 and bf16, every chunk a cluster launch; the block kernel, which
   the route leaves past its limits, at full width at B=256, f32 and bf16.  ``lstm_forward`` and ``lstm_backward`` (the fused LSTM layer) at
   (T, B, H) = (12, 4, 16) and at the two tier shapes of the training path,
   (128, 32, 256) and (256, 32, 256), through the route and with the forward
   on clusters of 8 and of 16 blocks: h_all, h_T, c_T within 1e-5 +
   1e-5 * max|plain| and all six gradients within 1e-5 + 1e-4 * max|plain|
   of the plain versions (f32, summed in another order), and their bf16
   instantiation (the ``param_dtype="bfloat16"`` streams) against the bf16
   twins at the same shapes (the small one at four input seeds): every
   output and gradient within 2 bf16 ulps of its scale and at most 1 %
   (small) or 25 % (the tier shapes) of a case's elements different, limits
   that a control (the f32 instantiation on the bf16 values: no rounding of
   h and dz) must fail at every case; the wide kernels (K3a-wide, K3b-wide:
   ``lstm_route`` sends H a multiple of 128 past a cluster's shared memory
   to them) the same way through the route, f32 at (T, B, H) = (8, 32,
   512), (128, 32, 512) and (64, 32, 1024) and at B = 8, 48 and 128 (T =
   16, H = 512), bf16 at (128, 32, 768) and (64, 32, 1024) and at B = 8, 48
   and 128 (T = 32, H = 768), each tensor against its share of elements
   that differ (``BF16_LSTM_WIDE_SHARES``), and its control, each call's
   launches on its route's wrappers only, and the clusters of 2 blocks
   the card holds at once at each H, at least the 64 a launch needs
   (``wide_clusters_that_fit``), and at B = 48 and 128 twenty calls of each
   wide kernel on the same inputs giving the same bits; one full
   SampleRNN-3 train step (B=32 x 2048) with the kernels against the same
   step on the CPU (plain versions): loss within 1e-5 relative, every
   parameter's gradient within 1e-5 + 1e-3 * max|plain|, at hidden 256 and,
   on the wide kernels, 512 and 768, and at 768 the bf16 step on the card
   (its loss within max(10 %, 5e-3) of the f32 CPU step's); the WaveNet decode
   kernels and the categorical sampler as the SampleRNN decode, each
   wrapper through its route (``WN_CLUSTER_ROUTE``: B up to 128 to the
   cluster kernel, ``csrc/wavenet_cluster.cu``, on clusters of 16 blocks;
   the block kernel beyond) and, small, the block kernel at every group;
   the cluster kernel on clusters of 16 whatever the route at B = 3 and 37
   (small) and 8, 37 (a ragged last group) and 256 (full width), argmax
   and T=0.9, over two chunkings, with the cluster barriers a step block 0
   counted (22 at WaveNet-10); the sampler (K9, ``csrc/categorical.cu``)
   also on bf16 and f16 logits and on strided views read in place (Q = 200,
   an offset that breaks its four-logit loads); the
   transformer kernels by teacher forcing too, K6 (``decode_window``) at
   B=1, 2 and 16 and K7 (``decode_chunk``) at B=1, 16 and 32, each over
   several chunk lengths (K6's window, K7's state carried; the tokens must
   not change), at a small size and at full width, with the grid barriers a
   step each kernel's block 0 counted (4L + 1 and 3L + 1); the
   tier-pyramid kernels (``decode_pyramid``, K8) by teacher forcing at B=1,
   2, 8, 16, 17, 32 and 64 through the route (the cluster kernel in clusters
   of 16 blocks up to 7 streams, of 8 up to 15, ``K8_CLUSTER_ROUTE``; the
   group kernel, groups of streams on clusters of 8, up to 45,
   ``K8_GROUP_ROUTE``; the block kernel beyond), the cluster kernel at one
   stream more than the clusters of 16 that fit (clusters loop over
   streams), the group kernel at B=31 in groups of 2 (at full width one
   group more than the clusters that fit), over several chunk lengths, the window carried,
   small and full width, with the cluster barriers a step block 0 counted
   (n_up (1 + 6L) + 1 + head layers, 29, whatever the group); the mu-law
   pair (K10) at 3,001 and 2,646,000 samples: compress
   ints equal to the plain twin's except by one where its value before
   truncation lies within rounding of an integer (1e-5 of it, relative),
   expand within 1e-6; the bf16 instantiations the same way against their
   bf16 twins: ``decode_single``/``decode_chunk`` on a bf16 pack (B=4 and
   B=64 small, B=4 and B=256 at full width) and K7 on a bf16 pack at B=1,
   16 and 32, small and full width, argmax and T=0.9; at the small width a
   control too, the f32 instantiation on bf16-valued weights (a kernel
   that skips the input rounding), whose tokens the bf16 check must refuse;
   one temperature a stream (``ROW_TEMPERATURES`` cycled over ``ROW_B``
   streams) through every decode kernel and route at the small widths (K1
   and K2 on the cluster and the block kernel, f32 and bf16 packs; K4 and
   K5 on both WaveNet kernels; K6; K7 f32 and bf16; K8's cluster, group and
   block kernels): the tokens verified by teacher forcing at those
   temperatures, and each row equal, bit for bit, to that row of the same
   decode at its row's temperature (``check_row_temperatures``);
3. the serving path at full width (bench.py's mu-law SampleRNN-3:
   frame_sizes (16, 8, 8), hidden 256, q 256, a two-layer Mish head; random
   weights from a seed): ``generate`` with B=4 (decode_single's route) and
   with B=256 for 16384 steps at temperature 0.9 (decode_chunk's route),
   median of 3 with spread, the B=256 output's first 4,096 steps verified
   as in phase 2,
   every launch of both a launch of K2's cluster kernel;
   ``stream_audio`` over 1600-step chunks, which must equal that output
   mu-law expanded; K2's route sweep (the cluster kernel at 16 and 8 blocks
   and the block kernel at B = 1 … 512 × 256 steps on the f32 and the bf16
   pack, decode_single's one launch at B = 1 … 63 the same way,
   ``generate``'s choice at each B against ``K2_CLUSTER_ROUTE`` for the
   pack's dtype); WaveNet-10 served the same way, every call's
   launches on the kernel ``WN_CLUSTER_ROUTE`` names for its B (the
   counters say so: ``generate`` B=256 on the block kernel, B=8 and the
   B=64 stream on the cluster kernel), and its route sweep (the block
   kernel and the cluster kernel at 16 blocks at B = 1 … 256 × 512 steps,
   in interleaved rounds, 9 at B=128; the route's choice within 2 % of the
   run's fastest); transformer8l
   (``benchmarks/bench_decode.py:104-115``: d 256, 8 heads, ff 1,024, 8
   layers, rf 64) ``generate`` at B=1 x 4,096 after a 64-token prompt (one
   K6 launch, its first 512 tokens verified), two chunks of the default
   re-feed ``stream_audio`` at B=1 (each one ``generate``), ``stream_audio``
   with ``MMK_DECODE_KV=1`` at B=1 and B=16 (one K7 launch a 1,600-step
   chunk; chunk latencies against the 100 ms of audio a chunk holds),
   ``generate`` at B=16 (one K6 launch), the batched window route at B=16
   over 256 argmax steps as a yardstick (``transformer8l_win_b16``, no
   kernel), and a bank written and
   reloaded through ``Checkpoint(...).network`` and decoded; jukebox3
   (``benchmarks/bench_decode.py:117-126``: frames (32, 16, 4), d 128, 8
   heads, ff 256, 2 layers a tier, rf 128) ``generate`` at B=1 and B=8 ×
   4,096 after a 128-token prompt (one launch of the cluster kernel each, in
   clusters of 16 and of 8 blocks), at B=16 and 32 (one of the group
   kernel each) and at B=64 (one of the block kernel), the first 512 tokens
   verified,
   ``stream_audio`` at B=1 (one launch of the cluster kernel a 1,600-step
   chunk, the window carried; equal to the expanded ``generate`` output),
   the window route over 64 steps (scaled), a bank reloaded and decoded,
   and the route sweep: the cluster kernel at both sizes, the group kernel
   at 4, 8 and 16 blocks (from B=16) and the block kernel at B = 1 … 128 ×
   256 steps, ``generate``'s choice at each B against ``K8_CLUSTER_ROUTE``
   and ``K8_GROUP_ROUTE``, which must be within 2 % of the run's fastest;
   then the
   bf16 routes, each number printed beside the f32 one of the same run:
   ``MMK_PALLAS_BF16=1`` SampleRNN-3 as above (every launch the bf16
   instantiation, the B=256 output's first 1,024 steps verified against the
   bf16 twin), ``MMK_DECODE_KV=1 MMK_DECODE_BF16=1`` transformer8l KV
   streams at B=1 and 16 (K7 on a bf16 pack; chunk-invariant; B=16's first
   256 tokens verified), and ``transformer8l_win_b16`` with
   ``MMK_DECODE_BF16=1`` (the window route in bf16);
4. the training path at full width: 60 s of 16 kHz two-tone audio made with
   scipy, ``DatasetConfig.create``, ``TrainARMLoop`` at B=32 x 2048 with
   TBPTT over 8 x 2048 samples, 4 epochs of 8 steps, seeded batches: every
   epoch's mean loss finite and the last below the first; ``epoch=4.ckpt``
   reloaded through ``Checkpoint(...).network`` with equal parameters and
   decoded at B=4 through decode_single (verified as in phase 2); the train
   step timed (median of 3 windows of 8 steps, CUDA events) and profiled;
   the training audio mu-law compressed through K10a (the dataset's tokens,
   under phase 2's rule) and expanded back through K10b; then the same run
   under ``trainer_kwargs={"param_dtype": "bfloat16"}``: master parameters
   and optimizer state f32, every LSTM call the bf16 instantiation (no f32
   K3 launch), epoch mean losses finite and falling, the last within
   max(10 %, 5e-3) of the f32 run's, the step timed and profiled beside the
   f32 one; then SampleRNN-3 with hidden 512 (f32) and 768 (bf16) for one
   epoch of 8 steps each on the wide kernels: every step's loss finite and
   the last below the first, every LSTM call a wide kernel's of the
   streams' dtype and no call of a plain version, the step timed and
   profiled; then SampleRNN-3 as a user monitors its training
   (``monitored_train_path``): two epochs with ``MONITOR_TRAINING``,
   ``OUTPUT_TRAINING="wav"``, one temperature an example, four examples of
   0.25 s every second epoch and ``loss_logs_file``: the wav files written,
   K1's cluster kernel launched by ``GenerateCallback`` (its time logged),
   the loss log read back; and one epoch under ``remat=True``, every loss
   finite and K3a launched twice a step for each tier;
5. the LSTM forward's sweep (on clusters of 8 and 16 at the tier shapes, f32
   and bf16, against ``LSTM_FWD_ROUTE``) and the backward's (its walk on
   clusters of 8 and 16, against ``LSTM_BWD_ROUTE``; the walk and dWh split
   by the profiler); each wrapper, its plain twin and (for the LSTM
   kernels) cuDNN's ``nn.LSTM`` in the same dtype, for K9 ``torch.multinomial``, timed at
   the main paths' shapes (the transformer and JukeBox twins over 64 steps,
   the SampleRNN twins over 512 and the WaveNet twins over 256, scaled;
   K8's block kernel at B=64, the route's shape, and also at B=16 and 32,
   K10 at 2,646,000 samples; K3a-wide and K3b-wide at (256, 32, 512) f32
   and (256, 32, 768) bf16, the wider tier at phase 4's wide widths; K9's
   row with an empty kernel's time, the floor of a launch, and a call's
   host time); a ``kernels`` JSON line of twenty-four rows (the twelve, K8's
   cluster kernel at B=1 and group kernel at B=16, K5 at the B=64 stream's
   width on WaveNet's cluster kernel, K1-, K2-, K3a-, K3b- and
   K7-bf16, and K3a-wide, K3b-wide and their bf16 instantiations; K2's and
   WaveNet's rows name the source of the kernel their
   route takes; K1's, K2's, K4's, K5's and K8's group kernel's rows carry
   the block kernel's time on the same inputs (K1's also its cluster
   launches on the main path, ``cluster_launches``), measured in the same run, under
   ``block_kernel_ms``), the card line, and the device line last.

``--quick`` runs phases 1-2 at the small size only (a build check);
``--bench`` runs phase 1, phase 3's timings without the checks, decode_chunk's
block kernel at B=256 for each number of streams a block owns, K2's route
sweep, the LSTM kernels' timings,
phase 4, the WaveNet streams-per-block sweep, K6 at B=16 against the
batched window route, K7 at B = 1, 4, 16 and 32, and the jukebox3 path with
K8's kernels at B = 1, 8, 16, 32 and 64, a cluster exchange's cost
(``tools/cluster_exchange_probe.py``), the cluster size, the clusters that
fit, the cluster barriers a step and the route sweep.
"""
import argparse
import contextlib
import copy
import functools
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit):
# f32 outside the tensor cores, dense bf16 on the tensor cores (the bound of
# the bf16-weight kernels), and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
FULL = dict(frame_sizes=(16, 8, 8), hidden_dim=256, q_levels=256, mlp_dim=256)
SMALL = dict(frame_sizes=(8, 4, 2), hidden_dim=32, q_levels=32, mlp_dim=32)
TEMPERATURE = 0.9
TOL = 1e-4  # a kernel token must score within TOL * max|score| of the row max
# the bf16 instantiations: rows beyond TOL widened by the twin's own order
# spread (one-ulp flips of bf16-rounded activations; verify_tokens) may be at
# most this share of the rows, each at most this far below its row's max.
# Set between the correct kernels (at most 0.12 % of rows, 2.8e-3 of a row's
# scale) and the control at the small width (the f32 instantiation on
# bf16-valued weights: no input rounding; at least 0.64 % of rows, and gaps
# past 1.5e-2 in most checks), from tools/bf16_check_power.py
BF16_FLIP_ROWS, BF16_FLIP_MAX = 0.003, 1e-2
N_SMALL, N_WIDE, STREAM_CHUNK, SEED = 4096, 16384, 1600, 1234
# K2's cluster kernel (csrc/samplernn_cluster.cu): a small net it takes (8 or
# more hidden units a block at 16 blocks), a ragged B (groups of 3 streams on
# the 15 clusters of 8 that fit: the last group holds one), and the route
# sweep's batches and steps
CLUSTER_MID = dict(frame_sizes=(8, 4, 2), hidden_dim=128, q_levels=64, mlp_dim=128)
K2_RAGGED_B = 37
K2_SWEEP_BATCHES, K2_SWEEP_N = (1, 4, 8, 16, 32, 64, 128, 256, 512), 256
# decode_single's (K1's) batches in the sweep: every B below 64 takes it
K1_SWEEP_BATCHES = (1, 4, 8, 16, 32, 63)
# every kernel's machine code, by source (tools/sass_digest.py with the card's toolkit,
# each kernel's digest, registers and stack): a change to a kernel renews its entry.  An
# entry may list several digests: of ~90 builds of one source of wavenet_decode.cu, 2 gave
# wavenet_decode_kernel<2> another schedule (same registers and stack) than the rest
SASS_DIGESTS = os.path.join(ROOT, "tools", "sass_digests.json")
N_BF16_VERIFY = 1024  # phase 3's bf16 B=256 output: its first steps verified
N_WIDE_VERIFY = 4096  # phase 3's f32 B=256 output: its first steps verified
# (T, B, D, H) of the LSTM checks: small, then the two tier LSTMs of the
# training path (2048 samples a window, frames of 16 and 8, B=32, H=256)
LSTM_SHAPES = ((12, 4, 8, 16), (128, 32, 256, 256), (256, 32, 256, 256))
# (T, B, D, H) of the wide route's checks (K3a-wide, K3b-wide: a cluster cannot hold
# Wh): JAX's seq2seq training shape (mimikit_tpu/modules/rnn.py:104-106, B=32 x T=8,
# networks/s2s_lstm.py:142's model_dim 512), a SampleRNN tier's T at H=512, and the
# wide route's limit, f32; then bf16 at H=768 and at the limit.  The phase-5 rows
# time the wider tier shape of the training path at the widths phase 4 trains
LSTM_WIDE_SHAPES = ((8, 32, 512, 512), (128, 32, 512, 512), (64, 32, 1024, 1024))
LSTM_WIDE_BF16_SHAPES = ((128, 32, 768, 768), (64, 32, 1024, 1024))
# the wide kernels at other batch sizes, short T: B = 8 (the least JAX's gate sends to its
# kernel), 48 (past one pass of 32 rows, the second ragged) and 128 (four passes); bf16 at
# T = 32, long enough for its control to part past BF16_LSTM_WIDE_SHARES
LSTM_WIDE_B_SHAPES = ((16, 8, 512, 512), (16, 48, 512, 512), (16, 128, 512, 512))
LSTM_WIDE_BF16_B_SHAPES = ((32, 8, 768, 768), (32, 48, 768, 768), (32, 128, 768, 768))
# calls of each wide kernel on the same inputs in check_wide_repeatable
WIDE_REPEATS = 20
LSTM_WIDE_ROWS = {"float32": (256, 32, 512, 512), "bfloat16": (256, 32, 768, 768)}
# phase 4's wide runs: SampleRNN-3 (FULL) with only hidden_dim changed, one epoch of
# TRAIN_STEPS steps, f32 at 512 and bf16 at 768 (both on the wide route)
WIDE_TRAIN = ((512, None), (768, "bfloat16"))
# the bf16 LSTM kernels against their bf16 twin: every output and gradient
# within BF16_LSTM_ULPS bf16 ulps of its scale, and at most BF16_LSTM_SHARE
# (the small case; the tier shapes) of a case's elements different.  The two
# round the same values; an f32 sum in another order flips a rounding now and
# then, and a flipped h feeds the later steps, more of them the longer and
# wider the layer.  Set between the correct kernels (at most 0.17 % small,
# 18.7 % at the tier shapes; the twin on the CPU against the twin on the card
# 20.1 %) and a control that skips the rounding of h and dz (at least 33.7 %
# small, 34.1 % at the tier shapes), from tools/bf16_lstm_check_power.py.
BF16_LSTM_ULPS, BF16_LSTM_SHARE = 2.0, (0.01, 0.25)
# At the wide kernels' shapes (LSTM_WIDE_BF16_SHAPES) a correct layer summing in
# another order parts from the card's twin in more elements than 25 %: the twin
# on the CPU in 31-35 % of the case's.  There each tensor is held to its own
# share of elements that differ, set between the larger of the kernels' and the
# CPU twin's readings and the control's, over 6 input seeds at both shapes
# (tools/bf16_lstm_check_power.py --wide; NVIDIA H100 80GB HBM3, 700 W):
# tensor: kernels, CPU twin, control -> limit
# h_all 2.8-4.3 %, 6.7-7.5, 15.1-15.3 -> 11 %; h_T 5.2-7.1, 8.0-9.1, 15.3-15.9 -> 12;
# c_T 5.2-7.3, 8.0-8.9, 15.1-15.6 -> 12; dx 30.6-34.7, 39.9-41.1, 49.4-49.7 -> 45;
# dWi 34.1-37.2, 40.3-41.4, 48.7-49.1 -> 45; dWh 34.5-37.8, 41.2-42.5, 51.9-52.1 -> 47;
# db 31.6-35.2, 36.7-39.7, 45.2-48.3 -> 42; dh0 26.0-29.1, 26.2-30.2, 44.4-45.8 -> 37;
# dc0 10.0-11.7, 10.0-12.6, 23.6-24.9 -> 18
BF16_LSTM_WIDE_SHARES = dict(h_all=0.11, h_T=0.12, c_T=0.12, dx=0.45, dWi=0.45, dWh=0.47,
                             db=0.42, dh0=0.37, dc0=0.18)
TRAIN_B, TRAIN_LEN, TRAIN_EPOCHS, TRAIN_STEPS = 32, 2048, 4, 8
# WaveNet-10 of benchmarks/bench_decode.py:91-101 (10 kernel-2 layers, dilations
# 1..512, rf 1,024, dims 128, q 256, a two-layer Mish head of 128), and a
# small net of the same shape; generate after a prompt of rf + 8 (:136-145)
WN_FULL = dict(blocks=(10,), dim=128, q_levels=256, mlp_dim=128)
WN_SMALL = dict(blocks=(3,), dim=16, q_levels=32, mlp_dim=16)
WN_N, WN_SMALL_B, WN_STREAM_B, WN_STREAM_CHUNKS = 2048, 8, 64, 8
# the WaveNet cluster kernel's full-width checks (B=37: groups of 6 on the 7
# clusters of 16 that fit, the last group ragged) and the route sweep of both
# kernels (WN_CLUSTER_ROUTE must send each B within WN_SWEEP_TIE of the
# run's fastest choice), in rounds of one call each, 3 rounds a B and 9 at
# B=128, where the two kernels lie ~3 % apart; the WaveNet twins' timed steps
# in phase 5 (scaled: a step of the twin costs the same whatever t)
WN_CLUSTER_BATCHES = (8, 37, 256)
WN_SWEEP_BATCHES, WN_SWEEP_N, WN_SWEEP_TIE = (1, 8, 32, 64, 128, 256), 512, 0.02
WN_SWEEP_ROUNDS, WN_PLAIN_STEPS = {128: 9}, 256
CAT_SHAPES = ((256, 256), (3, 7, 200))  # the sampler's checks: the path's and a ragged one
# and, on views that the kernel reads in place: (rows, Q, row stride, offset, dtype)
CAT_VIEWS = ((256, 256, 256, 0, "bfloat16"), (256, 256, 320, 0, "float32"),
             (300, 200, 512, 7, "float32"), (64, 200, 208, 8, "float16"))
# logits past the range of the kernel's hoisted division, which its threads send
# back through `/`: CAT_FAR's rows 0-15 with every 7th logit -inf, rows 16-31
# scaled by 1e-13 and rows 32-47 by 1e13 (2^40 is ~1.1e12)
CAT_FAR = (64, 256)
HOST_CALLS = 2000  # the sampler's calls from the host that time its launch path
# transformer8l of benchmarks/bench_decode.py:104-115 (mulaw_io q 256, mlp 128, an
# embedding input; d 256, 8 heads, ff 1,024, 8 post-norm layers, rf 64), and a
# small net of the same shape; generate B=1 x 4,096 after a 64-token prompt
# (:149), the KV stream at B=1 and B=16 in 1,600-step chunks (:306-311)
TF_FULL = dict(model_dim=256, n_heads=8, feedforward_dim=1024, num_layers=8, rf=64,
               q_levels=256, mlp_dim=128)
TF_SMALL = dict(model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2, rf=16, q_levels=32,
                mlp_dim=16)
TF_N, TF_N16, TF_KV_B, TF_KV_CHUNKS, TF_VERIFY, TF_PLAIN_STEPS = 4096, 256, 16, 6, 512, 64
SRN_PLAIN_STEPS = 512  # the SampleRNN twins' timed steps (phase 5), scaled
TF_WIN_BATCHES, TF_KV_BATCHES = (1, 2, 16), (1, 16, 32)  # phase 2's K6 and K7 checks
# windows longer than an attention tile (TF_KT, 64 keys): the small net at rf 160
# (three tiles, the last one partial), and transformer8l's widths at the rf 512 of
# benchmarks/bench_train.py:331-335
TF_SMALL_LONG = dict(TF_SMALL, rf=160)
TF_LONG = dict(TF_FULL, rf=512)
# K6 against the batched window route as B grows (generate's B limit), steps a call
TF_SWEEP_BATCHES, TF_SWEEP_N = (16, 32, 40, 48, 64, 128, 256), 16
# jukebox3 of benchmarks/bench_decode.py:117-126 (mulaw_io q 256, mlp 128, a framed-linear
# input; frames (32, 16, 4), d 128, 8 heads, ff 256, 2 Mish post-norm layers a tier, rf
# 128: a window of 128), and the JAX tests' small net of the same shape; generate B=1 and
# B=16 x 4,096 after a 128-token prompt (:172-176,276), the stream at B=1 in 1,600-step
# chunks
JB_FULL = dict(frame_sizes=(32, 16, 4), model_dim=128, n_heads=8, feedforward_dim=256,
               num_layers=2, rf=128, q_levels=256, mlp_dim=128)
JB_SMALL = dict(frame_sizes=(8, 4, 2), model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2,
                rf=16, q_levels=32, mlp_dim=16)
JB_N, JB_B, JB_VERIFY, JB_WIN_STEPS, JB_PLAIN_STEPS, JB_STREAM_CHUNKS = 4096, 16, 512, 64, 64, 6
# phase 2 checks K8 at these B through the route (clusters of 16 blocks, of 8, the
# group kernel, then the block kernel: ops/jukebox_decode.K8_CLUSTER_ROUTE,
# K8_GROUP_ROUTE: B = 16, 17 and 32 take the group kernel) and the group kernel at
# JB_GROUP_LOOP_B in groups of 2 (one group more than the clusters of 8 that fit); the
# path's generate
# at B = 1 and 8 takes the cluster kernel, at B = 16 and 32 the group kernel, at B = 64
# the block kernel; the route sweep times the cluster kernel at both cluster sizes, the
# group kernel at each of its sizes from B = 16 and the block kernel at each B,
# JB_SWEEP_N steps a call, and requires the route's choice within JB_SWEEP_TIE of the
# fastest (the run-to-run spread of a median of 3)
JB_CHECK_BATCHES, JB_PATH_BATCHES = (1, 2, 8, 16, 17, 32, 64), (1, 8, 16, 32, 64)
JB_GROUP_LOOP_B = 31
JB_WIDE, JB_SWEEP_BATCHES, JB_SWEEP_N, JB_SWEEP_TIE = 64, (1, 2, 4, 8, 16, 32, 48, 64, 128), 256, 0.02
MULAW_N = 2_646_000  # benchmarks/bench_preprocessing.py:33-59: 120 s at 22,050 Hz
# per-row temperatures (phase 2): the training monitor's (mimikit_tpu/demos/srnn.py:58),
# one a stream, cycled over ROW_B streams of ROW_N steps at the small widths
ROW_TEMPERATURES, ROW_B, ROW_N = (1.0, 0.75, 0.5, 0.1), 6, 160
# phase 4's monitored run: epochs (generation at the second), prompts' and outputs' seconds
MONITOR_EPOCHS, MONITOR_SEC = 2, 0.25


# the main paths' headline numbers, f32 and bf16, for the lines that print
# them side by side
SUMMARY = {}


def log(*a):
    print(*a, flush=True)


def merge_max(a, b):
    """{key: the larger of a's and b's value}."""
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in {**a, **b}}


@contextlib.contextmanager
def uncounted(*wrappers):
    """Launches made inside (a reference the path is compared with) are not
    the path's own: each wrapper's count is put back on the way out."""
    names = ("launches", "launches_bf16", "launches_cluster", "launches_group")
    saved = [{k: getattr(w, k) for k in names if hasattr(w, k)} for w in wrappers]
    try:
        yield
    finally:
        for w, counts in zip(wrappers, saved):
            for k, n in counts.items():
                setattr(w, k, n)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def make_net(mmk, torch, spec, seed, jitter=0.0):
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=spec["q_levels"], mlp_dim=spec["mlp_dim"])
    )
    cfg = mmk.SampleRNN.Config(
        frame_sizes=spec["frame_sizes"], hidden_dim=spec["hidden_dim"], io_spec=io
    )
    net = mmk.SampleRNN.from_config(cfg, device="cuda", seed=seed).eval()
    if jitter:
        # random-init nets can collapse to one argmax token; jittered weights
        # keep the trajectories varied so the token checks exercise every tier
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g).to(p.device) * jitter)
    if not mmk.supports_kernel_decode(net):
        raise AssertionError("the decode kernel's gate refused the net")
    return net


def make_prompt(torch, B, T, q, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, q, (B, T), generator=g, dtype=torch.int32).cuda()


def verify_tokens(torch, prompt, toks, t_first, tf_scores, free_run, tf_chunk=1024,
                  tf_scores_alt=None):
    """Teacher-forced check of kernel tokens ``toks`` (B, n) decoded after
    ``prompt``.  ``tf_scores(full, state, t, m)`` gives the plain twin's
    (m, B, Q) scores of steps t .. t+m-1 with ``full`` (prompt + kernel
    tokens) as its prompt, carrying ``state`` (the first call takes
    ``t = t_first``); ``free_run()`` gives the plain twin's own (B, n)
    tokens.  Returns (the largest score gap of a kernel token below its
    row's maximum, the number of streams where the free-running plain decode
    parted from the kernel's at a near-tie).  Raises when a token is outside
    the tolerance, or when the free-running plain tokens differ before the
    stream's first near-tie.

    ``tf_scores_alt``, for the bf16 twins: the same scores with the products
    summed in another order (f64).  Rounding each product's input to bf16
    turns a last-bit difference of a sum into a one-ulp difference of an
    activation now and then, and in some rows that moves the scores far
    past 1e-4, between two orders of the twin itself as between the twin and
    the kernel.  So a row's tolerance is widened by how far the other order
    moves that row's scores: what the order alone does there, measured.  A
    flip of the kernel's own order can still land in a row the other order
    left alone: such rows may be at most ``BF16_FLIP_ROWS`` of all, each
    within ``BF16_FLIP_MAX`` of its row's scale.  The log line says how far
    the order moved the rows, and how many rows lay beyond.  At the small
    width a kernel that skips the input rounding lands well past those
    limits, and the small checks run such a control and require this check
    to refuse it; at full width the order's own flips are as many as the
    control's, and the check catches gross faults only."""
    B, prior_t = prompt.shape
    n = toks.shape[1]
    full = torch.cat([prompt, toks.to(torch.int32)], 1).contiguous()
    worst, state, state_alt, spread_max, widened, flips, flip_max = 0.0, None, None, 0.0, 0, 0, 0.0
    near_tie = torch.full((B,), n, dtype=torch.long, device=toks.device)
    t = t_first
    while t < prior_t + n:
        m = min(tf_chunk, prior_t + n - t)
        scores, state = tf_scores(full, state, t, m)
        if tf_scores_alt is not None:
            alt, state_alt = tf_scores_alt(full, state_alt, t, m)
        lo = max(t, prior_t)
        if lo < t + m:
            s = scores[lo - t :]                           # (k, B, Q)
            tok = full[:, lo : t + m].T.long()             # (k, B)
            top2 = s.topk(2, dim=-1).values
            tol = TOL * s.abs().amax(-1)
            if tf_scores_alt is not None:
                spread = (s - alt[lo - t :]).abs().amax(-1)
                spread_max = max(spread_max, float((spread / s.abs().amax(-1)).max()))
                widened += int((spread > tol).sum())
                tol = tol + spread
            gap = top2[..., 0] - s.gather(-1, tok[..., None])[..., 0]
            bad = gap > tol
            if tf_scores_alt is None and bool(bad.any()):
                k, b = (int(v) for v in bad.nonzero()[0])
                raise AssertionError(
                    f"kernel token at step {lo + k}, stream {b}: {float(gap[k, b]):.3e}"
                    f" below the row max (tolerance {float(tol[k, b]):.3e})"
                )
            if bool(bad.any()):  # bf16: a one-ulp flip the other order did not show
                flips += int(bad.sum())
                flip_max = max(flip_max, float((gap / s.abs().amax(-1))[bad].max()))
            worst = max(worst, float(gap.max()))
            # a near-tie, or a flip row, ends the prefix the free run must match
            ties = ((top2[..., 0] - top2[..., 1]) <= tol) | bad    # (k, B)
            first = torch.where(
                ties.any(0), ties.long().argmax(0) + (lo - prior_t),
                torch.full_like(near_tie, n),
            )
            near_tie = torch.minimum(near_tie, first)
        t += m
    diff = free_run() != toks
    first_diff = torch.where(diff.any(1), diff.long().argmax(1), torch.full_like(near_tie, n))
    early = first_diff < near_tie
    if bool(early.any()):
        b = int(early.nonzero()[0])
        raise AssertionError(
            f"stream {b}: plain and kernel tokens differ at step {int(first_diff[b])},"
            f" before the first near-tie (step {int(near_tie[b])})"
        )
    if tf_scores_alt is not None:
        log(f"    (bf16 twin: the f64-summed twin moved a row's scores by up to {spread_max:.3e}"
            f" of its scale; {widened} of {B * n} rows' tolerances widened past 1e-4; {flips}"
            f" rows beyond that, the largest {flip_max:.3e} of its scale)")
        if flips > BF16_FLIP_ROWS * B * n or flip_max > BF16_FLIP_MAX:
            raise AssertionError(
                f"{flips} of {B * n} bf16 kernel tokens lie beyond their rows' tolerance (at most"
                f" {BF16_FLIP_ROWS:.2%} may), the largest {flip_max:.3e} of its row's scale (at"
                f" most {BF16_FLIP_MAX:g})")
    return worst, int((first_diff < n).sum())


def verify(torch, sd, model, prompt, toks, seed, temperature):
    """verify_tokens for the SampleRNN decode kernel (steps from rf);
    ``model`` is the net (the f32 twin) or a bf16 pack (the bf16 twin)."""
    net = getattr(model, "net", model)
    prior_t, n, rf = prompt.shape[1], toks.shape[1], net.rf

    def tf_scores(full, state, t, m, acc=torch.float32):
        state = state or sd.init_decode_state(net, full)
        _, scores = sd.decode_plain(model, full, state, t, m, t, m, seed, temperature,
                                    return_scores=True, accumulate=acc)
        return scores, state

    def tf_scores_alt(full, state, t, m):
        return tf_scores(full, state, t, m, torch.float64)

    def free_run():
        state = sd.init_decode_state(net, prompt)
        return sd.decode_plain(model, prompt, state, rf, prior_t + n - rf, prior_t, n, seed,
                               temperature)

    bf16 = model is not net and model.flat.dtype == torch.bfloat16
    return verify_tokens(torch, prompt, toks, rf, tf_scores, free_run,
                         tf_scores_alt=tf_scores_alt if bf16 else None)


def bf16_valued(torch, net):
    """A copy of ``net`` whose parameters hold their bf16-rounded values in
    f32: packed in f32, the bf16 route's weights read by the f32
    instantiation, which leaves the products' inputs unrounded."""
    net = copy.deepcopy(net)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    return net


def expect_caught(what, check):
    """``check()`` verifies a control's tokens (a kernel with a known fault):
    it must raise, else the check cannot tell that fault."""
    try:
        check()
    except AssertionError as e:
        log(f"    control {what}: caught ({e})")
        return
    raise AssertionError(f"the check passed the control {what}: it cannot tell the fault")


def check_kernels(torch, mmk, sd, spec, B_single, B_chunk, n, chunk_lens, jitter, bf16=False,
                  control=False):
    """Phase 2 at one size, on the f32 pack or (``bf16``) the bf16 one, each
    against its own twin; returns {wrapper: largest score gap} (the bf16
    instantiation's keys end in ``_bf16``).  With ``control`` (bf16), the
    f32 instantiation on the bf16-valued weights (no input rounding) runs the
    same calls, and the bf16 check must refuse its tokens."""
    net = make_net(mmk, torch, spec, seed=1, jitter=jitter)
    pack = sd.samplernn_weight_pack(net, torch.bfloat16 if bf16 else torch.float32)
    ctl = sd.samplernn_weight_pack(bf16_valued(torch, net)) if control else None
    twin = pack if bf16 else net
    rf, q = net.rf, spec["q_levels"]
    sfx = "_bf16" if bf16 else ""
    err = {"decode_single": 0.0, "decode_chunk": 0.0}
    # decode_single through its route and, where that is the cluster kernel,
    # on the block kernel too (cl=0)
    route = sd.cluster_size_for(pack, B_single) or 0
    for temp, cl in itertools.product((None, TEMPERATURE), (None, 0) if route else (None,)):
        mode = "argmax" if temp is None else f"T={temp}"
        # decode_single: the whole decode in one launch
        prompt = make_prompt(torch, B_single, 2 * rf, q, seed=2)
        before = sd.decode_single.launches_cluster
        toks = sd.decode_single(pack, prompt, n, 11, temp, cl=cl)
        torch.cuda.synchronize()
        took = sd.decode_single.last_cluster_size if \
            sd.decode_single.launches_cluster > before else 0
        if took != (route if cl is None else cl):
            raise AssertionError(f"decode_single B={B_single} cl={cl} took {took or 'the block'}"
                                 " kernel")
        how = (f"cluster kernel, {took} blocks, {sd.decode_single.last_streams} streams a group"
               f" on {sd.decode_single.last_clusters} clusters" if took else "block kernel")
        if spec is SMALL:
            for g in (1, 2, 4, 8):
                other = sd.decode_single(pack, prompt, n, 11, temp, group=g)
                if not torch.equal(other, toks):
                    raise AssertionError(f"decode_single group={g} changed the tokens")
            if temp is None and len(set(toks[0].tolist())) < 2:
                raise AssertionError("argmax tokens are constant: the check is vacuous")
        gap, parted = verify(torch, sd, twin, prompt, toks, 11, temp)
        err["decode_single"] = max(err["decode_single"], gap)
        log(f"  decode_single{sfx} ({how}) B={B_single} n={n} {mode}: ok, max gap {gap:.3e},"
            f" {parted} streams parted at near-ties")
        if ctl is not None:
            with uncounted(sd.decode_single):
                bad = sd.decode_single(ctl, prompt, n, 11, temp, cl=took)
            expect_caught(f"decode_single B={B_single} {mode}",
                          lambda: verify(torch, sd, twin, prompt, bad, 11, temp))
        if cl == 0:
            continue
        # decode_chunk: the state carried across launches of several lengths
        prompt = make_prompt(torch, B_chunk, 2 * rf, q, seed=3)
        prior_t = prompt.shape[1]
        runs = []
        for C in chunk_lens:
            state = sd.init_decode_state(net, prompt)
            parts = [
                sd.decode_chunk(pack, prompt, state, t0, min(C, prior_t + n - t0), 13, temp)
                for t0 in range(rf, prior_t + n, C)
            ]
            runs.append(torch.cat(parts, 1)[:, prior_t - rf :])
        torch.cuda.synchronize()
        for C, r in zip(chunk_lens[1:], runs[1:]):
            if not torch.equal(r, runs[0]):
                raise AssertionError(f"decode_chunk with chunk {C} changed the tokens")
        gap, parted = verify(torch, sd, twin, prompt, runs[0], 13, temp)
        err["decode_chunk"] = max(err["decode_chunk"], gap)
        log(f"  decode_chunk{sfx} B={B_chunk} n={n} chunks {chunk_lens} {mode}: ok,"
            f" max gap {gap:.3e}, {parted} streams parted at near-ties")
        if ctl is not None:
            with uncounted(sd.decode_chunk):
                bad = sd.decode_chunk(ctl, prompt, sd.init_decode_state(net, prompt), rf,
                                      prior_t + n - rf, 13, temp)[:, prior_t - rf :]
            expect_caught(f"decode_chunk B={B_chunk} {mode}",
                          lambda: verify(torch, sd, twin, prompt, bad, 13, temp))
    return {k + sfx: v for k, v in err.items()}


def check_cluster(torch, mmk, sd, spec, batches, n, chunk_lens, jitter, bf16=False,
                  sizes=None, control=False):
    """Phase 2 for K2's kernels: ``decode_chunk`` at each B of ``batches`` on
    the cluster kernel at each cluster size of ``sizes`` (0: the block
    kernel; None: the route's, which must be the cluster kernel), argmax and
    sampled, the state carried over chunks of each length of ``chunk_lens``
    (the tokens must not change), verified by teacher forcing against the
    plain twin (the bf16 one for a bf16 pack).  With ``control`` (bf16), the
    f32 instantiation of the same kernel on the bf16-valued weights (no input
    rounding) runs each case too, and the bf16 check must refuse its tokens.
    Returns {wrapper: largest score gap}."""
    net = make_net(mmk, torch, spec, seed=1, jitter=jitter)
    pack = sd.samplernn_weight_pack(net, torch.bfloat16 if bf16 else torch.float32)
    ctl = sd.samplernn_weight_pack(bf16_valued(torch, net)) if control else None
    twin = pack if bf16 else net
    rf, q = net.rf, spec["q_levels"]
    key = "decode_chunk_bf16" if bf16 else "decode_chunk"
    worst = 0.0
    for B in batches:
        prompt = make_prompt(torch, B, 2 * rf, q, seed=50 + B)
        prior_t = prompt.shape[1]
        for cl in sizes or (sd.cluster_size_for(pack, B),):
            if cl is None:
                raise AssertionError(f"decode_chunk B={B} does not route to the cluster kernel")
            force = None if sizes is None else cl
            for temp in (None, TEMPERATURE):
                runs = []
                for C in chunk_lens:
                    state = sd.init_decode_state(net, prompt)
                    before = sd.decode_chunk.launches_cluster, sd.decode_chunk.launches
                    parts = [sd.decode_chunk(pack, prompt, state, t0, min(C, prior_t + n - t0), 13,
                                             temp, cl=force)
                             for t0 in range(rf, prior_t + n, C)]
                    cluster = sd.decode_chunk.launches_cluster - before[0]
                    if sd.decode_chunk.launches - before[1] != len(parts) or \
                            cluster != (len(parts) if cl else 0):
                        raise AssertionError(f"a chunk did not launch the {cl or 'block'} kernel")
                    runs.append(torch.cat(parts, 1)[:, prior_t - rf :])
                torch.cuda.synchronize()
                for C, r in zip(chunk_lens[1:], runs[1:]):
                    if not torch.equal(r, runs[0]):
                        raise AssertionError(f"decode_chunk ({cl or 'block'}) with chunk {C}"
                                             " changed the tokens")
                gap, parted = verify(torch, sd, twin, prompt, runs[0], 13, temp)
                worst = max(worst, gap)
                mode = "argmax" if temp is None else f"T={temp}"
                how = (f"cluster kernel, {cl} blocks, {sd.decode_chunk.last_streams} streams a"
                       f" group on {sd.decode_chunk.last_clusters} clusters" if cl
                       else "block kernel")
                log(f"  {key} ({how}) B={B} n={n} chunks {chunk_lens} {mode}: ok, max gap"
                    f" {gap:.3e}, {parted} streams parted at near-ties")
                if ctl is not None:
                    with uncounted(sd.decode_chunk):
                        bad = sd.decode_chunk(ctl, prompt, sd.init_decode_state(net, prompt), rf,
                                              prior_t + n - rf, 13, temp, cl=cl)
                    expect_caught(f"decode_chunk ({cl or 'block'}) B={B} {mode}",
                                  lambda: verify(torch, sd, twin, prompt,
                                                 bad[:, prior_t - rf :], 13, temp))
    return {key: worst}


def samplernn_route_sweep(torch, sd, net):
    """K2's cluster kernel at both cluster sizes and its block kernel at each
    B of ``K2_SWEEP_BATCHES`` (T=0.9, ``K2_SWEEP_N`` steps a call, medians of
    3), on the f32 pack and the bf16 one, and the same for ``decode_single``'s
    one-launch form (K1) at each B of ``K1_SWEEP_BATCHES``: the measurement
    behind ``K2_CLUSTER_ROUTE``, which both wrappers read.  Checks that
    ``generate`` (under ``MMK_PALLAS_BF16=1`` for the bf16 pack; B >= 64
    through decode_chunk, below through decode_single) takes the kernel the
    route names, and says whether the route sends any B to a slower choice
    than this run's fastest.  Returns {(wrapper, dtype name, B): {choice: us
    a step}}."""
    rf, q = net.rf, FULL["q_levels"]
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        pack = sd.samplernn_weight_pack(net, dtype)
        env = {"MMK_PALLAS_BF16": "1"} if dtype == torch.bfloat16 else {}
        slower = []
        with uncounted(sd.decode_chunk, sd.decode_single):
            for B in K1_SWEEP_BATCHES:
                prompt = make_prompt(torch, B, 2 * rf, q, seed=70 + B)
                route = sd.cluster_size_for(pack, B) or 0
                before = sd.decode_single.launches_cluster, sd.decode_single.launches_bf16
                with env_set(**env):
                    net.generate((prompt,), 1, seed=SEED)
                took = sd.decode_single.last_cluster_size if \
                    sd.decode_single.launches_cluster > before[0] else 0
                if took != route or (sd.decode_single.launches_bf16 > before[1]) != bool(env):
                    raise AssertionError(f"SampleRNN generate B={B} ({dn}) took {took}, not"
                                         f" {route}")
                times, fit = {}, {}
                for cl in (16, 8, 0):
                    fn = lambda: sd.decode_single(pack, prompt, K2_SWEEP_N, SEED,  # noqa: E731
                                                  TEMPERATURE, cl=cl)
                    fn()
                    fit[cl] = (sd.decode_single.last_streams, sd.decode_single.last_clusters)
                    times[cl] = spread(cuda_ms(torch, fn, reps=3))
                us = table["decode_single", dn, B] = {cl: 1e3 * t[0] / K2_SWEEP_N
                                                      for cl, t in times.items()}
                fastest = min(times, key=lambda k: times[k][0])
                if times[route][0] > times[fastest][0]:
                    slower.append(f"decode_single B={B}")
                log(f"  SampleRNN-3 {dn} decode_single B={B} x {K2_SWEEP_N} steps, us a step"
                    f" (median of 3, spread): cluster kernel at 16 blocks {us[16]:.2f}"
                    f" ({times[16][1]:.2%}; groups of {fit[16][0]} on {fit[16][1]} clusters), at 8"
                    f" blocks {us[8]:.2f} ({times[8][1]:.2%}; groups of {fit[8][0]} on"
                    f" {fit[8][1]}), block kernel {us[0]:.2f} ({times[0][1]:.2%}); decode_single"
                    f" takes {'the block kernel' if not route else f'clusters of {route}'}")
            for B in K2_SWEEP_BATCHES:
                prompt = make_prompt(torch, B, 2 * rf, q, seed=90 + B)
                route = sd.cluster_size_for(pack, B) or 0
                if B >= net._CHUNKED_MIN_B:
                    before = sd.decode_chunk.launches_cluster, sd.decode_chunk.launches_bf16
                    with env_set(**env):
                        net.generate((prompt,), 1, seed=SEED)
                    took = sd.decode_chunk.last_cluster_size if \
                        sd.decode_chunk.launches_cluster > before[0] else 0
                    if took != route or \
                            (sd.decode_chunk.launches_bf16 > before[1]) != bool(env):
                        raise AssertionError(f"SampleRNN generate B={B} ({dn}) took {took}, not"
                                             f" {route}")
                times, fit = {}, {}
                for cl in (16, 8, 0):
                    fn = lambda: sd.decode_chunk(pack, prompt,  # noqa: E731
                                                 sd.init_decode_state(net, prompt), rf,
                                                 K2_SWEEP_N, SEED, TEMPERATURE, cl=cl)
                    fn()
                    fit[cl] = (sd.decode_chunk.last_streams, sd.decode_chunk.last_clusters)
                    times[cl] = spread(cuda_ms(torch, fn, reps=3))
                us = table["decode_chunk", dn, B] = {cl: 1e3 * t[0] / K2_SWEEP_N
                                                     for cl, t in times.items()}
                fastest = min(times, key=lambda k: times[k][0])
                if times[route][0] > times[fastest][0]:
                    slower.append(f"decode_chunk B={B}")
                log(f"  SampleRNN-3 {dn} B={B} x {K2_SWEEP_N} steps, us a step (median of 3,"
                    f" spread): cluster kernel at 16 blocks {us[16]:.2f} ({times[16][1]:.2%};"
                    f" groups of {fit[16][0]} on {fit[16][1]} clusters), at 8 blocks"
                    f" {us[8]:.2f} ({times[8][1]:.2%}; groups of {fit[8][0]} on {fit[8][1]}),"
                    f" block kernel {us[0]:.2f} ({times[0][1]:.2%}); decode_chunk takes"
                    f" {'the block kernel' if not route else f'clusters of {route}'}")
        log(f"  K2_CLUSTER_ROUTE[{dn}] = {sd.K2_CLUSTER_ROUTE[dtype]}: "
            + (f"sends {slower} to a slower choice than this run's fastest" if slower
               else "sends no B of the sweep to a slower choice than this run's fastest"))
    return table


def sass_check(sources):
    """Every kernel of each built source (``sources``: (path, library)) has
    the machine code ``SASS_DIGESTS`` holds for it (``tools/sass_digest.py``),
    and no kernel is missing or new."""
    from tools.sass_digest import digests

    with open(SASS_DIGESTS) as f:
        want = json.load(f)
    for src, lib in sources:
        got = digests(lib)
        allowed = {k: v if isinstance(v, list) else [v] for k, v in want[src.name].items()}
        changed = {k: got.get(k) for k in set(got) | set(allowed)
                   if got.get(k) not in allowed.get(k, ())}
        if changed:
            raise AssertionError(f"{src.name}'s SASS differs from {SASS_DIGESTS}: {changed}")
        log(f"  {src.name}: the SASS digests of its {len(got)} kernels equal"
            f" tools/sass_digests.json's")


def cuda_ms(torch, fn, reps):
    """Milliseconds of ``fn()`` by CUDA events, one per rep."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def graph_ms(torch, fn, per, reps):
    """Device milliseconds of one ``fn()``, one value per rep: ``per`` calls
    captured in a CUDA graph, the graph replayed between a pair of CUDA
    events, so the host's launch cost stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # capture wants its warm-up on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    return [m / per for m in cuda_ms(torch, graph.replay, reps)]


def decode_bound(pack, B, prior_t, t0, n, out_len):
    """(bound_ms, bound_by) for one decode call: the larger of its operations
    over the card's rate for the pack's type (f32 on the CUDA cores; bf16 on
    the tensor cores) and its bytes (each input read once, the weights at
    the pack's width, each output written once) over the memory rate."""
    fs, up, H = pack.frame_sizes, pack.up_factors, pack.hidden_dim
    steps = range(t0, t0 + n)
    mac = n * (fs[-1] * H + sum(i * o for i, o in pack.head_dims))
    for i in range(len(fs) - 1):
        fires = sum(1 for t in steps if t % fs[i] == 0)
        mac += fires * (fs[i] * H + 2 * H * 4 * H + H * up[i] * H)
    flops = 2.0 * mac * B
    state = 4 * B * (fs[0] + 2 * (len(fs) - 1) * H + sum(up) * H)
    nbytes = (pack.flat.element_size() * pack.flat.numel() + 4 * B * prior_t + 2 * state
              + 4 * B * out_len)
    t_ops, t_bytes = flops / peak_flops(pack), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def peak_flops(pack) -> float:
    """The card's operation rate for a weight pack's type."""
    return PEAK_F32_FLOPS if pack.flat.element_size() == 4 else PEAK_BF16_FLOPS


def spread(xs):
    med = statistics.median(xs)
    return med, (max(xs) - min(xs)) / med


def main_path(torch, mmk, net, p4, p256, label=""):
    """Time the user entry points at full width; returns the generated
    buffers {B: (B, prior_t + n)}.  Each timing lands in ``SUMMARY`` under
    ``label``."""
    q = FULL["q_levels"]
    log(f"  SampleRNN-3{label}: {net.n_parameters} parameters")
    outs = {}
    for B, prompt, n in ((4, p4, N_SMALL), (256, p256, N_WIDE)):
        net.generate((prompt,), 64, temperature=TEMPERATURE, seed=SEED)  # lazy set-up

        def run():
            outs[B] = net.generate((prompt,), n, temperature=TEMPERATURE, seed=SEED)[0]

        ms = cuda_ms(torch, run, reps=3)
        med, spr = spread(ms)
        toks = outs[B][:, prompt.shape[1]:]
        if toks.shape != (B, n) or int(toks.min()) < 0 or int(toks.max()) >= q:
            raise AssertionError(f"generate B={B}: bad tokens {tuple(toks.shape)}")
        if len(set(toks[0].tolist())) < 2:
            raise AssertionError(f"generate B={B}: constant sampled tokens")
        SUMMARY[f"srnn{label}_b{B}_ms"] = med
        log(f"  generate{label} B={B} n={n} T={TEMPERATURE}: {B * n / (med / 1e3):.6g} samples/s"
            f" (median of 3: {med:.3f} ms, spread {spr:.3%}; {ms})")

    lat, audio = [], []
    it = mmk.stream_audio(net, (p256,), STREAM_CHUNK, temperature=TEMPERATURE, seed=SEED)
    t = time.perf_counter()
    for _ in range(12):
        audio.append(next(it))
        now = time.perf_counter()
        lat.append(1e3 * (now - t))
        t = now
    it.close()
    # noise is keyed by absolute step: the stream must be generate's decode,
    # mu-law expanded, chunk for chunk (this holds the read-behind copies too)
    n_cmp = (N_WIDE // STREAM_CHUNK) * STREAM_CHUNK
    toks = outs[256][:, p256.shape[1] : p256.shape[1] + n_cmp].cpu().numpy()
    ref = mmk.MuLawExpand(FULL["q_levels"])(toks)
    got = np.concatenate(audio, axis=1)[:, :n_cmp]
    if got.shape != ref.shape or not np.array_equal(got, ref):
        raise AssertionError("stream_audio differs from the expanded generate output")
    lat_s = sorted(lat)
    SUMMARY[f"srnn{label}_chunk_p50_ms"] = statistics.median(lat)
    SUMMARY[f"srnn{label}_chunk_p95_ms"] = lat_s[int(0.95 * (len(lat) - 1) + 0.5)]
    log(f"  stream_audio{label} B=256, 12 chunks of {STREAM_CHUNK} steps (equal to the expanded"
        f" generate output): per-chunk ms p50"
        f" {statistics.median(lat):.3f}, p95 {lat_s[int(0.95 * (len(lat) - 1) + 0.5)]:.3f},"
        f" max {max(lat):.3f} (first {lat[0]:.3f}); {lat}")
    return outs


def bench(torch, mmk, sd, fl):
    """--bench: the serving path's timings, decode_chunk's block kernel at
    B=256 for each number of streams a block can own, K2's route sweep, the
    LSTM kernels' timings and the training path (phase 4)."""
    net = make_net(mmk, torch, FULL, seed=0)
    rf = net.rf
    p4, p256 = (make_prompt(torch, B, 2 * rf, FULL["q_levels"], seed=B) for B in (4, 256))
    main_path(torch, mmk, net, p4, p256)
    pack = sd.samplernn_weight_pack(net)
    for g in (1, 2, 4, 8):
        ms = cuda_ms(torch, lambda: sd.decode_chunk(
            pack, p256, sd.init_decode_state(net, p256), rf, net._CHUNK, SEED, TEMPERATURE,
            group=g, cl=0), reps=3)
        med, spr = spread(ms)
        log(f"  decode_chunk (the block kernel) B=256 steps={net._CHUNK} group={g}: {med:.3f} ms"
            f" (median of 3, spread {spr:.3%})")
    samplernn_route_sweep(torch, sd, net)
    lstm_timings(torch, fl, torch.float32)
    lstm_timings(torch, fl, torch.bfloat16)
    train_path(torch, mmk, fl, sd, None)



# -- WaveNet serving (the decode kernel K4/K5 and the categorical sampler K9) ------

def make_wavenet(mmk, torch, wd, spec, seed, sampler_impl="jax", jitter=0.0):
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
        q_levels=spec["q_levels"], mlp_dim=spec["mlp_dim"], input_module_type="embedding",
        sampler_impl=sampler_impl))
    cfg = mmk.WaveNet.Config(io_spec=io, blocks=spec["blocks"], dims_dilated=(spec["dim"],),
                             skips_dim=spec["dim"], residuals_dim=spec["dim"], pad_side=0)
    net = mmk.WaveNet.from_config(cfg, device="cuda", seed=seed).eval()
    if jitter:  # varied argmax trajectories, as make_net's
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g).to(p.device) * jitter)
    if not wd.supports_kernel_decode(net):
        raise AssertionError("the WaveNet decode kernel's gate refused the net")
    return net


def verify_wn(torch, wd, pack, prompt, toks, seed, temperature):
    """verify_tokens for the WaveNet decode kernels.  Steps 1 .. prior_t - 1
    teacher-force the scored run and the free run alike, so the twin runs
    them once and each run starts at prior_t from a copy of that state."""
    prior_t, n = prompt.shape[1], toks.shape[1]
    warm = wd.init_decode_state(pack, prompt)
    wd.decode_plain(pack, prompt, warm, 1, prior_t - 1, 1, 0, seed, temperature)

    def copy():
        return wd.WaveNetDecodeState(warm.tok.clone(), warm.rings.clone(), warm.dilations)

    def tf_scores(full, state, t, m):
        state = state or copy()
        _, scores = wd.decode_plain(pack, full, state, t, m, t, m, seed, temperature,
                                    return_scores=True)
        return scores, state

    def free_run():
        return wd.decode_plain(pack, prompt, copy(), prior_t, n, prior_t, n, seed, temperature)

    return verify_tokens(torch, prompt, toks, prior_t, tf_scores, free_run)


def check_wavenet(torch, mmk, wd, spec, B_single, B_chunk, n, chunk_lens, jitter):
    """Phase 2 for the WaveNet decode kernels at one size, each wrapper
    through its route (``WN_CLUSTER_ROUTE``: the cluster kernel up to 128
    streams, the block kernel beyond) and, at the small size, on the block
    kernel (``cl=0``) at every group too; returns {wrapper: largest score
    gap}."""
    net = make_wavenet(mmk, torch, wd, spec, seed=1, jitter=jitter)
    pack = wd.wavenet_weight_pack(net)
    prior_t, q = net.rf + 8, spec["q_levels"]
    err = {"wavenet_decode_single": 0.0, "wavenet_decode_chunk": 0.0,
           "wavenet_decode_chunk_cluster": 0.0}
    for temp in (None, TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"
        prompt = make_prompt(torch, B_single, prior_t, q, seed=2)
        kernels = ((None, "route"),) + (((0, "block kernel"),) if spec is WN_SMALL else ())
        for cl, what in kernels:
            toks = wd.decode_single(pack, prompt, n, 11, temp, cl=cl)
            torch.cuda.synchronize()
            if cl == 0:
                for g in wd.GROUPS:
                    if not torch.equal(wd.decode_single(pack, prompt, n, 11, temp, group=g,
                                                        cl=0), toks):
                        raise AssertionError(f"WaveNet decode_single group={g} changed the tokens")
            if spec is WN_SMALL and temp is None and len(set(toks[0].tolist())) < 2:
                raise AssertionError("argmax tokens are constant: the check is vacuous")
            gap, parted = verify_wn(torch, wd, pack, prompt, toks, 11, temp)
            err["wavenet_decode_single"] = max(err["wavenet_decode_single"], gap)
            log(f"  WaveNet decode_single B={B_single} n={n} {mode} ({what}: "
                f"{wn_kernel_name(wd, pack, B_single, cl)}): ok, max gap {gap:.3e}, {parted}"
                f" streams parted at near-ties")
        prompt = make_prompt(torch, B_chunk, prior_t, q, seed=3)
        for cl, what in kernels:
            runs = []
            for C in chunk_lens:
                state = wd.init_decode_state(pack, prompt)
                parts = [wd.decode_chunk(pack, prompt, state, t0, min(C, prior_t + n - t0), 13,
                                         temp, cl=cl)
                         for t0 in range(1, prior_t + n, C)]
                runs.append(torch.cat(parts, 1)[:, prior_t - 1 :])
            torch.cuda.synchronize()
            for C, r in zip(chunk_lens[1:], runs[1:]):
                if not torch.equal(r, runs[0]):
                    raise AssertionError(f"WaveNet decode_chunk with chunk {C} changed the tokens")
            gap, parted = verify_wn(torch, wd, pack, prompt, runs[0], 13, temp)
            key = "wavenet_decode_chunk" + (
                "_cluster" if (wd.route(pack, B_chunk) if cl is None else cl) else "")
            err[key] = max(err[key], gap)
            log(f"  WaveNet decode_chunk B={B_chunk} n={n} chunks {chunk_lens} {mode} ({what}:"
                f" {wn_kernel_name(wd, pack, B_chunk, cl)}): ok, max gap {gap:.3e}, {parted}"
                f" streams parted at near-ties")
    return err


def wn_kernel_name(wd, pack, B, cl=None):
    """The kernel B streams of ``pack``'s net take with ``cl`` (None: the
    route's)."""
    size = wd.route(pack, B) if cl is None else cl
    return f"the cluster kernel at {size} blocks" if size else "the block kernel"


def check_wavenet_cluster(torch, mmk, wd, spec, batches, n, chunk_lens, jitter):
    """Phase 2 for the WaveNet cluster kernel (``csrc/wavenet_cluster.cu``)
    on clusters of 16 blocks whatever the route, at each of ``batches``
    (ragged groups where B is not a multiple of the group), over two
    chunkings, argmax and T=0.9: teacher forcing against ``decode_plain``,
    the chunkings' tokens equal to ``decode_single``'s, and the cluster
    barriers a step block 0 counted equal to ``exchanges_per_step``.
    Returns {wrapper: largest score gap}."""
    net = make_wavenet(mmk, torch, wd, spec, seed=1, jitter=jitter)
    pack = wd.wavenet_weight_pack(net)
    prior_t, q = net.rf + 8, spec["q_levels"]
    err = {"wavenet_decode_single": 0.0, "wavenet_decode_chunk_cluster": 0.0}
    want = wd.exchanges_per_step(pack)
    for temp in (None, TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"
        for B in batches:
            prompt = make_prompt(torch, B, prior_t, q, seed=40 + B)
            toks = wd.decode_single(pack, prompt, n, 17, temp, cl=16)
            torch.cuda.synchronize()
            w = wd.decode_single
            got = int(w.last_barriers.item()) / (prior_t + n - 1)
            if got != want:
                raise AssertionError(f"WaveNet cluster kernel: {got} cluster barriers a step,"
                                     f" not {want}")
            gap, parted = verify_wn(torch, wd, pack, prompt, toks, 17, temp)
            for key in err:  # decode_chunk's tokens are these (checked below)
                err[key] = max(err[key], gap)
            log(f"  WaveNet cluster kernel decode_single B={B} n={n} {mode}, clusters of 16"
                f" ({w.last_clusters} fit), groups of {w.last_streams}: ok, max gap"
                f" {gap:.3e}, {parted} streams parted at near-ties; {want} cluster barriers"
                f" a step")
            for C in chunk_lens:
                state = wd.init_decode_state(pack, prompt)
                parts = [wd.decode_chunk(pack, prompt, state, t0, min(C, prior_t + n - t0), 17,
                                         temp, cl=16)
                         for t0 in range(1, prior_t + n, C)]
                run = torch.cat(parts, 1)[:, prior_t - 1 :]
                if not torch.equal(run, toks):
                    raise AssertionError(f"WaveNet cluster kernel B={B}: chunks of {C} changed"
                                         f" the tokens")
            log(f"    decode_chunk in chunks of {chunk_lens}: the same tokens")
    return err


def categorical_scores(torch, x, temperature, seed):
    """The plain twin's (rows, Q) scores: logits / t + the hashed noise."""
    from mimikit_tpu_torch.ops.noise import gumbel_rows

    flat = x.reshape(-1, x.shape[-1]).float()
    return flat / temperature + gumbel_rows(seed, flat.shape[0], flat.shape[1], x.device)


def check_categorical(torch, cat):
    """Phase 2 for the sampler: every drawn index scores within TOL *
    max|score| of its row's maximum under the plain twin's scores, at
    CAT_SHAPES (f32), on CAT_FAR's logits past the kernel's fast division
    (max|score| over the finite scores) and on the views of CAT_VIEWS (bf16
    and f16 logits, rows apart by a stride, an offset that breaks the
    four-logit loads), each read in place (the wrapper's view of the rows is
    the logits' own memory) in one launch."""
    worst = 0.0
    cases = [(shape, torch.randn(*shape, generator=torch.Generator().manual_seed(len(shape))))
             for shape in CAT_SHAPES]
    far = torch.randn(*CAT_FAR, generator=torch.Generator().manual_seed(11))
    far[:16, ::7] = -float("inf")
    far[16:32] *= 1e-13
    far[32:48] *= 1e13
    cases.append((f"{CAT_FAR} past the fast division (-inf, 1e-13, 1e13)", far))
    for rows, Q, stride, off, dt in CAT_VIEWS:
        base = torch.randn(rows * stride + off, generator=torch.Generator().manual_seed(Q))
        cases.append((f"{dt} {rows} x {Q} at stride {stride}, offset {off}",
                      (base, rows, Q, stride, off, getattr(torch, dt))))
    for what, x in cases:
        if isinstance(x, tuple):
            base, rows, Q, stride, off, dt = x
            x = base.to(dt).cuda().as_strided((rows, Q), (stride, 1), off)
        else:
            x = x.cuda()
        shape = tuple(x.shape)
        if cat._rows(x).data_ptr() != x.data_ptr():
            raise AssertionError(f"categorical {what}: the wrapper copies the logits")
        n = cat.categorical.launches
        k = cat.categorical(x, TEMPERATURE, SEED)
        torch.cuda.synchronize()
        if tuple(k.shape) != shape[:-1] or cat.categorical.launches != n + 1:
            raise AssertionError(f"categorical {what}: output shape {tuple(k.shape)},"
                                 f" {cat.categorical.launches - n} launches")
        s = categorical_scores(torch, x, TEMPERATURE, SEED)
        gap = s.amax(-1) - s.gather(-1, k.reshape(-1, 1).long())[:, 0]
        tol = TOL * s.masked_fill(~torch.isfinite(s), 0).abs().amax(-1)
        if bool((gap > tol).any()):
            raise AssertionError(f"categorical {what}: a drawn index {float(gap.max()):.3e}"
                                 f" below its row max")
        same = int((k == cat.categorical_plain(x, TEMPERATURE, SEED)).sum())
        worst = max(worst, float(gap.max()))
        log(f"  categorical {what}: ok, max gap {float(gap.max()):.3e}, {same} of {k.numel()}"
            f" indices equal to the plain twin's")
    return {"categorical": worst}


def wn_counts(wd):
    """The WaveNet wrappers' launch counters: (decode_single's, its cluster
    kernel's, decode_chunk's, its cluster kernel's)."""
    return (wd.decode_single.launches, wd.decode_single.launches_cluster,
            wd.decode_chunk.launches, wd.decode_chunk.launches_cluster)


def wn_route_taken(wd, pack, B, before, what):
    """Raise unless every WaveNet launch since ``before`` (``wn_counts``)
    went to the kernel ``WN_CLUSTER_ROUTE`` names for B."""
    d = [a - b for a, b in zip(wn_counts(wd), before)]
    launches, cluster = d[0] + d[2], d[1] + d[3]
    want = wd.route(pack, B)
    if launches == 0 or cluster != (launches if want else 0):
        raise AssertionError(f"{what}: {cluster} of {launches} launches on the cluster kernel;"
                             f" the route names {wn_kernel_name(wd, pack, B)}")
    size = (wd.decode_single if d[1] else wd.decode_chunk).last_cluster_size if want else None
    if want and size != want:
        raise AssertionError(f"{what}: clusters of {size}, the route names {want}")
    log(f"  {what}: {launches} launches, all on {wn_kernel_name(wd, pack, B)} (the route's)")


def wavenet_path(torch, mmk, wd, cat):
    """Phase 3b: WaveNet-10 served at full width through the user entry
    points, each call through the kernel ``WN_CLUSTER_ROUTE`` names for its
    B (the launch counters say so); returns (net, prompts, launches: the
    decode_single, the block kernel's and the cluster kernel's decode_chunk
    and the sampler's, gap of the verified output)."""
    net = make_wavenet(mmk, torch, wd, WN_FULL, seed=0)
    rf, q = net.rf, WN_FULL["q_levels"]
    log(f"  WaveNet-10: {net.n_parameters} parameters, rf {rf}")
    prompts = {B: make_prompt(torch, B, rf + 8, q, seed=B) for B in (256, WN_SMALL_B, WN_STREAM_B)}
    for w in (wd.decode_single, wd.decode_chunk, cat.categorical):
        w.launches = 0
    wd.decode_single.launches_cluster = wd.decode_chunk.launches_cluster = 0
    pack = wd.wavenet_weight_pack(net)
    outs = {}
    for B in (256, WN_SMALL_B):
        prompt = prompts[B]
        net.generate((prompt,), 16, temperature=TEMPERATURE, seed=SEED)  # lazy set-up

        def run():
            outs[B] = net.generate((prompt,), WN_N, temperature=TEMPERATURE, seed=SEED)[0]

        before = wn_counts(wd)
        ms = cuda_ms(torch, run, reps=3)
        wn_route_taken(wd, pack, B, before, f"WaveNet generate B={B}")
        med, spr = spread(ms)
        toks = outs[B][:, prompt.shape[1]:]
        if toks.shape != (B, WN_N) or int(toks.min()) < 0 or int(toks.max()) >= q:
            raise AssertionError(f"WaveNet generate B={B}: bad tokens {tuple(toks.shape)}")
        if len(set(toks[0].tolist())) < 2:
            raise AssertionError(f"WaveNet generate B={B}: constant sampled tokens")
        log(f"  WaveNet generate B={B} n={WN_N} T={TEMPERATURE}: {B * WN_N / (med / 1e3):.6g}"
            f" samples/s (median of 3: {med:.3f} ms, spread {spr:.3%}; {ms})")
    gap, parted = verify_wn(torch, wd, wd.wavenet_weight_pack(net), prompts[256],
                            outs[256][:, rf + 8:], SEED, TEMPERATURE)
    log(f"  WaveNet generate B=256 output verified: max gap {gap:.3e}, {parted} streams"
        f" parted at near-ties")

    p64 = prompts[WN_STREAM_B]
    lat, audio = [], []
    before = wn_counts(wd)
    it = mmk.stream_audio(net, (p64,), STREAM_CHUNK, temperature=TEMPERATURE, seed=SEED)
    t = time.perf_counter()
    for _ in range(WN_STREAM_CHUNKS):
        audio.append(next(it))
        now = time.perf_counter()
        lat.append(1e3 * (now - t))
        t = now
    it.close()
    wn_route_taken(wd, pack, WN_STREAM_B, before, f"WaveNet stream_audio B={WN_STREAM_B}")
    n_cmp = WN_STREAM_CHUNKS * STREAM_CHUNK
    with uncounted(wd.decode_single, wd.decode_chunk, cat.categorical):
        ref = net.generate((p64,), n_cmp, temperature=TEMPERATURE, seed=SEED)[0][:, rf + 8:]
    if not np.array_equal(np.concatenate(audio, 1), mmk.MuLawExpand(q)(ref.cpu().numpy())):
        raise AssertionError("WaveNet stream_audio differs from the expanded generate output")
    lat_s = sorted(lat)
    log(f"  WaveNet stream_audio B={WN_STREAM_B}, {WN_STREAM_CHUNKS} chunks of {STREAM_CHUNK}"
        f" steps (equal to the expanded generate output): per-chunk ms p50"
        f" {statistics.median(lat):.3f}, p95 {lat_s[int(0.95 * (len(lat) - 1) + 0.5)]:.3f},"
        f" max {max(lat):.3f} (first {lat[0]:.3f}); {lat}")

    # a bank written by the port, reloaded through Checkpoint(...).network
    root = os.path.join(ROOT, "build", "chip_smoke_wavenet")
    shutil.rmtree(root, ignore_errors=True)
    mmk.Checkpoint("wavenet10", 1, root).create(net)
    net2 = mmk.Checkpoint("wavenet10", 1, root, device="cuda").network.eval()
    live = net.state_dict()
    diff = [k for k, v in net2.state_dict().items() if not torch.equal(v, live[k])]
    if diff or type(net2) is not type(net):
        raise AssertionError(f"reloaded WaveNet differs: {type(net2).__name__}, {diff}")
    p8 = prompts[WN_SMALL_B]
    toks = net2.generate((p8,), 1024)[0][:, rf + 8:]
    g2, parted = verify_wn(torch, wd, wd.wavenet_weight_pack(net2), p8, toks, SEED, None)
    log(f"  epoch=1.ckpt of WaveNet-10 reloaded with equal parameters; argmax generate"
        f" B={WN_SMALL_B} x 1024 from it verified (max gap {g2:.3e}, {parted} streams parted"
        f" at near-ties)")

    # one eval forward with sampler_impl="pallas": the sampler on the path
    net_p = make_wavenet(mmk, torch, wd, WN_FULL, seed=0, sampler_impl="pallas")
    y = net_p((prompts[256][:, :rf],), temperature=TEMPERATURE)[0]
    torch.cuda.synchronize()
    if tuple(y.shape) != (256, 1) or int(y.min()) < 0 or int(y.max()) >= q:
        raise AssertionError(f"eval forward with sampler_impl='pallas': {tuple(y.shape)}")
    log(f"  eval forward B=256 with sampler_impl='pallas': ok, {tuple(y.shape)}")
    launches = {"wavenet_decode_single": wd.decode_single.launches,
                "wavenet_decode_chunk": wd.decode_chunk.launches - wd.decode_chunk.launches_cluster,
                "wavenet_decode_chunk_cluster": wd.decode_chunk.launches_cluster,
                "categorical": cat.categorical.launches}
    log(f"  launches on the WaveNet serving path: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the WaveNet path was never launched: {launches}")
    wavenet_route_sweep(torch, wd, net, pack)
    return net, prompts, launches, gap


def wavenet_route_sweep(torch, wd, net, pack):
    """WaveNet-10's block kernel and its cluster kernel at each cluster size
    the plan admits, at each of ``WN_SWEEP_BATCHES`` streams (decode_chunk,
    T=0.9, ``WN_SWEEP_N`` steps a call; medians of rounds that call each
    kernel once, ``WN_SWEEP_ROUNDS`` of them, else 3): the measurement behind
    ``WN_CLUSTER_ROUTE``.  Raises unless the route's choice is within
    ``WN_SWEEP_TIE`` of this run's fastest at every B."""
    prior_t, q = net.rf + 8, WN_FULL["q_levels"]
    slower = []
    with uncounted(wd.decode_single, wd.decode_chunk):
        for B in WN_SWEEP_BATCHES:
            prompt = make_prompt(torch, B, prior_t, q, seed=90 + B)
            fns, fit, ms = {}, {}, {}
            for cl in (0,) + tuple(c for c in wd.CLUSTER_SIZES if wd.max_streams(pack, c)):
                def fn(cl=cl):
                    wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1,
                                    WN_SWEEP_N, SEED, TEMPERATURE, cl=cl)

                fn()
                fns[cl], ms[cl] = fn, []
                fit[cl] = (wd.decode_chunk.last_clusters, wd.decode_chunk.last_streams)
            rounds = WN_SWEEP_ROUNDS.get(B, 3)
            for _ in range(rounds):
                for cl, fn in fns.items():
                    ms[cl] += cuda_ms(torch, fn, reps=1)
            times = {cl: spread(v) for cl, v in ms.items()}
            route = wd.route(pack, B) or 0
            fastest = min(times, key=lambda k: times[k][0])
            if times[route][0] > times[fastest][0] * (1 + WN_SWEEP_TIE):
                slower.append(B)
            cells = [f"{'block kernel' if cl == 0 else f'clusters of {cl}'}"
                     f" {1e3 * v[0] / WN_SWEEP_N:.2f} ({v[1]:.2%}"
                     + ("" if cl == 0 else f"; {fit[cl][0]} fit, groups of {fit[cl][1]}") + ")"
                     for cl, v in times.items()]
            log(f"  WaveNet B={B} x {WN_SWEEP_N} steps, us a step (median of {rounds}, spread): "
                + ", ".join(cells) + f"; the route takes {wn_kernel_name(wd, pack, B)}")
    log(f"  WN_CLUSTER_ROUTE = {wd.WN_CLUSTER_ROUTE}: "
        + (f"sends B = {slower} to a choice slower than this run's fastest by more than"
           f" {WN_SWEEP_TIE:.0%}" if slower else
           f"sends every B of the sweep to this run's fastest choice (within {WN_SWEEP_TIE:.0%})"))
    if slower:
        raise AssertionError(f"the WaveNet route sends B = {slower} to a slower kernel")


def wavenet_bound(pack, B, prior_t, n_steps, out_len):
    """(bound_ms, bound_by) for one WaveNet decode call: f32 operations of
    the gated convs, the skip/residual products and the head, against the
    weights, prompt, tokens and rings (read once, written once) over the
    memory rate."""
    D, S = pack.dim, pack.skips_dim
    mac = sum(2 * D * 2 * D + D * (S + (D if r else 0)) for r in pack.has_res)
    mac += sum(i * o for i, o in pack.head_dims)
    flops = 2.0 * mac * B * n_steps
    state = 4 * B * (D * sum(pack.dilations) + 1)
    nbytes = 4 * pack.flat.numel() + 4 * B * prior_t + 2 * state + 4 * B * out_len
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def categorical_bound(rows, Q):
    """(bound_ms, bound_by) for one sampler call: each logit read once and
    each index written once, against ~20 operations a logit (the scale, the
    counter hash, two logs, the compare)."""
    t_ops, t_bytes = 20.0 * rows * Q / PEAK_F32_FLOPS, 4.0 * rows * (Q + 1) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def wavenet_rows(torch, wd, cat, net, prompts, launches, err):
    """Phase 5 rows of K4, K5 and K9: kernel (the one ``WN_CLUSTER_ROUTE``
    names), plain twin, yardstick, bound, and for K4 and K5 the block kernel
    on the same call (``block_kernel_ms``).  K5 has two rows: B=256 (the
    route's block kernel) and the stream's B=64 (its cluster kernel)."""
    pack = wd.wavenet_weight_pack(net)
    p8, p64, p256 = prompts[WN_SMALL_B], prompts[WN_STREAM_B], prompts[256]
    prior_t = p8.shape[1]
    n_single = prior_t + WN_N - 1
    C = net._CHUNK
    x = torch.randn(*CAT_SHAPES[0], generator=torch.Generator().manual_seed(7)).cuda()
    per = 100  # sampler calls a CUDA graph replays: its device time, not the host's launch cost

    def timed(fn, per, reps, warm=True):
        if per > 1:
            return graph_ms(torch, fn, per, reps)
        if warm:
            fn()
        return cuda_ms(torch, fn, reps)

    def chunk(prompt, cl=None):
        return lambda: wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1, C,
                                       SEED, TEMPERATURE, cl=cl)

    W = WN_PLAIN_STEPS  # the twins' steps timed, scaled to the call's

    def plain_chunk(prompt):
        return lambda: wd.decode_plain(pack, prompt, wd.init_decode_state(pack, prompt), 1, W, 1,
                                       W, SEED, TEMPERATURE)

    calls = {
        "wavenet_decode_single": (
            lambda: wd.decode_single(pack, p8, WN_N, SEED, TEMPERATURE),
            lambda: wd.decode_plain(pack, p8, wd.init_decode_state(pack, p8), 1, W, prior_t,
                                    WN_N, SEED, TEMPERATURE),
            None, 1, wavenet_bound(pack, WN_SMALL_B, prior_t, n_single, WN_N),
            "mimikit_tpu/ops/pallas_decode.py:402", f"B={WN_SMALL_B} steps={n_single}",
            lambda: wd.decode_single(pack, p8, WN_N, SEED, TEMPERATURE, cl=0), WN_SMALL_B),
        "wavenet_decode_chunk": (
            chunk(p256), plain_chunk(p256), None, 1, wavenet_bound(pack, 256, prior_t, C, C),
            "mimikit_tpu/ops/pallas_decode.py:559", f"B=256 steps={C}", chunk(p256, 0), 256),
        "wavenet_decode_chunk_cluster": (
            chunk(p64), plain_chunk(p64), None, 1,
            wavenet_bound(pack, WN_STREAM_B, prior_t, C, C),
            "mimikit_tpu/ops/pallas_decode.py:559", f"B={WN_STREAM_B} steps={C}",
            chunk(p64, 0), WN_STREAM_B),
        "categorical": (
            lambda: cat.categorical(x, TEMPERATURE, SEED),
            lambda: cat.categorical_plain(x, TEMPERATURE, SEED),
            lambda: torch.multinomial(torch.softmax(x / TEMPERATURE, -1), 1),
            per, categorical_bound(*CAT_SHAPES[0]),
            "mimikit_tpu/ops/pallas_kernels.py:159", f"(B, Q)={CAT_SHAPES[0]}", None, None),
    }
    rows = []
    for name, (kern, plain, lib, n, (bound, by), replaces, shape, block, B) in calls.items():
        if name == "categorical":
            source = "mimikit_tpu_torch/csrc/categorical.cu"
        elif wd.route(pack, B):
            source = "mimikit_tpu_torch/csrc/wavenet_cluster.cu"
        else:
            source = "mimikit_tpu_torch/csrc/wavenet_decode.cu"
        with uncounted(cat.categorical):
            k_ms, k_spr = spread(timed(kern, n, 3))
            # the sampler's plain twin copies its seed to the card, which no graph
            # captures: it is timed as a user runs it, n calls from the host
            p_ms = cuda_ms(torch, lambda: [plain() for _ in range(n)], 1)[0] / n
            scale = 1 if name == "categorical" else (
                n_single if name == "wavenet_decode_single" else C) / W
            p_ms *= scale
            l_ms = None if lib is None else spread(timed(lib, n, 3))[0]
            b_ms = block_kernel_ms(torch, block)
        extra = {}
        if name == "categorical":
            import launch_floor

            # the floor of one launch (an empty kernel, timed as the kernel is), and a
            # call's host time: HOST_CALLS calls from the host, then a synchronize
            extra["empty_kernel_ms"] = spread(graph_ms(torch, launch_floor.empty_launch, n,
                                                       3))[0]
            with uncounted(cat.categorical):
                kern()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    kern()
                torch.cuda.synchronize()
            extra["host_us"] = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
            log(f"  categorical: an empty kernel {extra['empty_kernel_ms']:.5f} ms (the floor of"
                f" a launch, {n} in a CUDA graph); a call from the host {extra['host_us']:.2f} us"
                f" (the mean over {HOST_CALLS} calls)")
        how = (f"; kernel and yardstick device time, {n} calls in a CUDA graph; plain twin {n}"
               " calls from the host") if n > 1 else ""
        on = "" if B is None else f" on {wn_kernel_name(wd, pack, B)}"
        log(f"  {name} {shape}{on}: kernel {k_ms:.5f} ms (median of 3, spread {k_spr:.2%}{how}),"
            f" plain twin {p_ms:.5f} ms" + (f" ({W} steps timed, scaled by {scale:g})"
                                             if scale != 1 else "")
            + f", yardstick {l_ms}, bound {bound:.5f} ms by {by}"
            + (f"; the block kernel {b_ms:.5f} ms" if b_ms is not None else ""))
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches[name],
            max_abs_err=err[name], ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
            library_ms=l_ms, **({"block_kernel_ms": b_ms} if b_ms is not None else {}),
            **extra,
        ))
    return rows


def wavenet_bench(torch, mmk, wd, cat):
    """--bench: WaveNet serving's timings and decode_chunk at B=256 for each
    number of streams a block can own."""
    net, prompts, launches, _ = wavenet_path(torch, mmk, wd, cat)
    pack = wd.wavenet_weight_pack(net)
    p256 = prompts[256]
    for g in wd.GROUPS:
        ms = cuda_ms(torch, lambda: wd.decode_chunk(
            pack, p256, wd.init_decode_state(pack, p256), 1, net._CHUNK, SEED, TEMPERATURE,
            group=g), reps=3)
        med, spr = spread(ms)
        log(f"  WaveNet decode_chunk B=256 steps={net._CHUNK} group={g}: {med:.3f} ms"
            f" ({1e3 * med / net._CHUNK:.2f} us a step; median of 3, spread {spr:.3%})")
    wavenet_rows(torch, wd, cat, net, prompts, launches, {k: 0.0 for k in launches})


# -- SimpleTransformer serving (the window-refeed kernel K6, the KV-ring kernel K7) --

def make_transformer(mmk, torch, td, spec, seed, jitter=0.0):
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
        q_levels=spec["q_levels"], mlp_dim=spec["mlp_dim"], input_module_type="embedding"))
    cfg = mmk.SimpleTransformer.Config(
        io_spec=io, model_dim=spec["model_dim"], n_heads=spec["n_heads"],
        feedforward_dim=spec["feedforward_dim"], num_layers=spec["num_layers"], rf=spec["rf"],
        input_dropout=0.0)
    net = mmk.SimpleTransformer.from_config(cfg, device="cuda", seed=seed).eval()
    if jitter:  # varied argmax trajectories, as make_net's
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g).to(p.device) * jitter)
    if not td.supports_kernel_decode(net):
        raise AssertionError("the transformer decode kernels' gate refused the net")
    return net


def verify_window(torch, td, pack, prompt, toks, seed, temperature):
    """verify_tokens for the window decode kernel (K6): the plain twin scores
    each position from the window of kernel tokens before it."""
    prior_t, n = prompt.shape[1], toks.shape[1]

    def tf_scores(full, state, t, m):
        _, scores = td.decode_window_plain(pack, full, t, m, seed, temperature, return_scores=True)
        return scores, None

    def free_run():
        return td.decode_window_plain(pack, prompt, prior_t, n, seed, temperature)

    return verify_tokens(torch, prompt, toks, prior_t, tf_scores, free_run, tf_chunk=256)


def verify_kv(torch, tk, pack, prompt, toks, seed, temperature):
    """verify_tokens for the KV-ring kernel (K7).  Steps 1 .. prior_t - 1
    teacher-force the scored run and the free run alike, so the twin runs
    them once for each sum order and each run starts at prior_t from a copy
    of that state."""
    prior_t, n = prompt.shape[1], toks.shape[1]
    prompt_T = prompt.t().contiguous()
    bf16 = pack.flat.dtype == torch.bfloat16
    warm = {}
    for acc in (torch.float32, torch.float64) if bf16 else (torch.float32,):
        warm[acc] = tk.init_kv_state(pack, prompt)
        tk.decode_chunk_plain(pack, prompt_T, warm[acc], 1, prior_t - 1, seed, temperature,
                              accumulate=acc)

    def copy(acc):
        return tk.TransformerKVState(warm[acc].tok.clone(), warm[acc].ring.clone())

    def tf_scores(full, state, t, m, acc=torch.float32):
        state = state or copy(acc)
        _, scores = tk.decode_chunk_plain(pack, full.t().contiguous(), state, t, m, seed,
                                          temperature, return_scores=True, accumulate=acc)
        return scores, state

    def tf_scores_alt(full, state, t, m):
        return tf_scores(full, state, t, m, torch.float64)

    def free_run():
        return tk.decode_chunk_plain(pack, prompt_T, copy(torch.float32), prior_t, n, seed,
                                     temperature)

    return verify_tokens(torch, prompt, toks, prior_t, tf_scores, free_run,
                         tf_scores_alt=tf_scores_alt if bf16 else None)


def kv_run(torch, tk, pack, prompt, n, chunk, temperature, seed):
    """K7 over positions 1 .. prior_t + n - 1 in launches of ``chunk`` steps,
    the state carried; returns the n tokens after the prompt."""
    prior_t = prompt.shape[1]
    prompt_T = prompt.t().contiguous()
    state = tk.init_kv_state(pack, prompt)
    parts = [tk.decode_chunk(pack, prompt_T, state, t0, min(chunk, prior_t + n - t0), temperature,
                             seed)
             for t0 in range(1, prior_t + n, chunk)]
    return torch.cat(parts, 1)[:, prior_t - 1 :]


def window_run(torch, td, pack, prompt, n, chunk, temperature, seed):
    """K6 over the n tokens after ``prompt`` in launches of ``chunk`` steps,
    each launch's prompt the tokens so far (the window is K6's whole state,
    and its noise is keyed by absolute position)."""
    buf = prompt
    while buf.shape[1] < prompt.shape[1] + n:
        m = min(chunk, prompt.shape[1] + n - buf.shape[1])
        buf = torch.cat([buf, td.decode_window(pack, buf, m, seed, temperature)], 1)
    return buf[:, prompt.shape[1]:]


def barriers_per_step(wrapper, n_steps):
    """Grid barriers a step of the wrapper's last launch, as block 0 counted
    them (one before the first step)."""
    return (int(wrapper.last_barriers) - 1) / n_steps


def check_transformer(torch, mmk, td, tk, spec, n, window_batches, kv_batches, chunk_lens,
                      jitter, bf16=False, control=False):
    """Phase 2 for the transformer kernels at one size: K6 at
    ``window_batches`` and K7 at ``kv_batches``, each over several chunk
    lengths (the tokens must not change), argmax and T=0.9; with ``bf16``
    K7 alone, on the bf16 pack against its bf16 twin (K6 has no bf16
    variant), and with ``control`` K7's f32 instantiation on the
    bf16-valued weights too, whose tokens the bf16 check must refuse.
    Returns {wrapper: largest score gap} (K7's bf16 key ends in ``_bf16``)."""
    net = make_transformer(mmk, torch, td, spec, seed=1, jitter=jitter)
    if bf16 and not td.supports_kernel_decode(net, wbytes=2):
        raise AssertionError("K7's bf16 gate refused the net")
    pack = td.transformer_weight_pack(net, torch.bfloat16 if bf16 else torch.float32)
    ctl = td.transformer_weight_pack(bf16_valued(torch, net)) if control else None
    rf, q, L = spec["rf"], spec["q_levels"], spec["num_layers"]
    sfx = "_bf16" if bf16 else ""
    if bf16:
        window_batches = ()
    err = {"transformer_decode_window": 0.0, "transformer_decode_chunk": 0.0}
    for temp in (None, TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"
        for B in window_batches:
            prompt = make_prompt(torch, B, rf, q, seed=2 + B)
            runs = [window_run(torch, td, pack, prompt, n, C, temp, 11) for C in chunk_lens]
            torch.cuda.synchronize()
            per_step = barriers_per_step(td.decode_window, n % chunk_lens[-1] or chunk_lens[-1])
            if per_step != 4 * L + 1:
                raise AssertionError(f"K6 passed {per_step} grid barriers a step, not 4L + 1")
            for C, r in zip(chunk_lens[1:], runs[1:]):
                if not torch.equal(r, runs[0]):
                    raise AssertionError(
                        f"transformer decode_window with chunk {C} changed the tokens")
            if temp is None and len(set(runs[0][0].tolist())) < 2:
                raise AssertionError("K6 argmax tokens are constant: the check is vacuous")
            gap, parted = verify_window(torch, td, pack, prompt, runs[0], 11, temp)
            err["transformer_decode_window"] = max(err["transformer_decode_window"], gap)
            log(f"  transformer decode_window rf={rf} B={B} n={n} chunks {chunk_lens} {mode}: ok,"
                f" max gap"
                f" {gap:.3e}, {parted} streams parted at near-ties; {per_step:g} grid barriers a"
                f" step ({L} layers)")
        for B in kv_batches:
            prompt = make_prompt(torch, B, rf, q, seed=5 + B)
            runs = [kv_run(torch, tk, pack, prompt, n, C, temp, 13) for C in chunk_lens]
            torch.cuda.synchronize()
            steps = rf + n - 1  # K7 runs positions 1 .. rf + n - 1
            per_step = barriers_per_step(tk.decode_chunk, steps % chunk_lens[-1] or chunk_lens[-1])
            if per_step != 3 * L + 1:
                raise AssertionError(f"K7 passed {per_step} grid barriers a step, not 3L + 1")
            for C, r in zip(chunk_lens[1:], runs[1:]):
                if not torch.equal(r, runs[0]):
                    raise AssertionError(
                        f"transformer decode_chunk with chunk {C} changed the tokens")
            if temp is None and len(set(runs[0][0].tolist())) < 2:
                raise AssertionError("K7 argmax tokens are constant: the check is vacuous")
            gap, parted = verify_kv(torch, tk, pack, prompt, runs[0], 13, temp)
            err["transformer_decode_chunk"] = max(err["transformer_decode_chunk"], gap)
            log(f"  transformer decode_chunk{sfx} rf={rf} B={B} n={n} chunks {chunk_lens} {mode}:"
                f" ok, max gap {gap:.3e}, {parted} streams parted at near-ties; {per_step:g} grid"
                f" barriers a step ({L} layers)")
            if ctl is not None:
                with uncounted(tk.decode_chunk):
                    bad = kv_run(torch, tk, ctl, prompt, n, chunk_lens[0], temp, 13)
                expect_caught(f"transformer decode_chunk B={B} {mode}",
                              lambda: verify_kv(torch, tk, pack, prompt, bad, 13, temp))
    if bf16:
        return {"transformer_decode_chunk_bf16": err["transformer_decode_chunk"]}
    return err


def chunk_latencies(it, n_chunks):
    """Host ms between successive chunks of a stream, and the chunks."""
    lat, chunks = [], []
    t = time.perf_counter()
    for _ in range(n_chunks):
        chunks.append(next(it))
        now = time.perf_counter()
        lat.append(1e3 * (now - t))
        t = now
    it.close()
    return lat, chunks


def latency_line(lat):
    s = sorted(lat)
    return (f"per-chunk ms p50 {statistics.median(lat):.3f}, p95"
            f" {s[int(0.95 * (len(lat) - 1) + 0.5)]:.3f}, max {max(lat):.3f} (first {lat[0]:.3f});"
            f" {lat}")


def transformer_path(torch, mmk, td, tk):
    """Phase 3c: transformer8l served at full width through the user entry
    points; returns (net, prompts, launches, gap of the verified output)."""
    net = make_transformer(mmk, torch, td, TF_FULL, seed=0)
    rf, q = TF_FULL["rf"], TF_FULL["q_levels"]
    log(f"  transformer8l: {net.n_parameters} parameters, rf {rf}")
    prompts = {B: make_prompt(torch, B, rf, q, seed=B) for B in (1, 16)}
    p1 = prompts[1]
    expand = mmk.MuLawExpand(q)
    td.decode_window.launches = 0
    tk.decode_chunk.launches = 0

    # generate B=1: one K6 launch
    net.generate((p1,), 16, temperature=TEMPERATURE, seed=SEED)  # lazy set-up
    outs = {}

    def run():
        outs[1] = net.generate((p1,), TF_N, temperature=TEMPERATURE, seed=SEED)[0]

    ms = cuda_ms(torch, run, reps=3)
    med, spr = spread(ms)
    toks = outs[1][:, rf:]
    if toks.shape != (1, TF_N) or int(toks.min()) < 0 or int(toks.max()) >= q:
        raise AssertionError(f"transformer generate B=1: bad tokens {tuple(toks.shape)}")
    if len(set(toks[0].tolist())) < 2:
        raise AssertionError("transformer generate B=1: constant sampled tokens")
    log(f"  transformer generate B=1 n={TF_N} T={TEMPERATURE}: {TF_N / (med / 1e3):.6g} samples/s"
        f" ({1e3 * med / TF_N:.2f} us a step; median of 3: {med:.3f} ms, spread {spr:.3%}; {ms})")
    pack = td.transformer_weight_pack(net)
    pack_ms, pack_spr = spread(cuda_ms(torch, lambda: td.transformer_weight_pack(net), reps=3))
    log(f"  of which the weight pack each generate call builds: {pack_ms:.3f} ms (median of 3,"
        f" spread {pack_spr:.3%})")
    gap, parted = verify_window(torch, td, pack, p1, toks[:, :TF_VERIFY], SEED, TEMPERATURE)
    log(f"  its first {TF_VERIFY} tokens verified: max gap {gap:.3e}, {parted} streams parted at"
        f" near-ties")

    # the default stream re-feeds: each chunk is one generate, one K6 launch
    before = td.decode_window.launches
    lat, chunks = chunk_latencies(
        mmk.stream_audio(net, (p1,), STREAM_CHUNK, temperature=TEMPERATURE, seed=SEED), 2)
    if td.decode_window.launches - before < 2:
        raise AssertionError("the re-feed stream did not launch K6 once a chunk")
    seeds = torch.Generator().manual_seed(SEED)
    buf, ref = p1, []
    with uncounted(td.decode_window, tk.decode_chunk):
        for _ in range(2):
            sub = int(torch.randint(0, 2**31 - 1, (1,), generator=seeds))
            out = net.generate((buf,), STREAM_CHUNK, temperature=TEMPERATURE, seed=sub)[0]
            ref.append(out[:, buf.shape[1]:].cpu().numpy())
            buf = out[:, -net._window_len():]  # the stream re-feeds the window
    if not np.array_equal(np.concatenate(chunks, 1), expand(np.concatenate(ref, 1))):
        raise AssertionError("transformer re-feed stream differs from its chunked generates")
    log(f"  transformer stream_audio (re-feed) B=1, 2 chunks of {STREAM_CHUNK} steps (equal to"
        f" the chunked generates): {latency_line(lat)}")

    # MMK_DECODE_KV=1: the KV-ring stream, one K7 launch a chunk
    os.environ["MMK_DECODE_KV"] = "1"
    try:
        for B in (1, TF_KV_B):
            before = tk.decode_chunk.launches
            lat, chunks = chunk_latencies(
                mmk.stream_audio(net, (prompts[B],), STREAM_CHUNK, temperature=TEMPERATURE,
                                 seed=SEED), TF_KV_CHUNKS)
            if tk.decode_chunk.launches - before < TF_KV_CHUNKS:
                raise AssertionError(f"the KV stream B={B} did not launch K7 once a chunk")
            n_cmp = 2 * STREAM_CHUNK
            with uncounted(td.decode_window, tk.decode_chunk):
                ref = kv_run(torch, tk, pack, prompts[B], n_cmp, 1000, TEMPERATURE, SEED)
            got = np.concatenate(chunks, 1)
            if got.shape != (B, TF_KV_CHUNKS * STREAM_CHUNK) or not np.array_equal(
                    got[:, :n_cmp], expand(ref.cpu().numpy())):
                raise AssertionError(f"transformer KV stream B={B} is not chunk-invariant")
            SUMMARY[f"kv_b{B}_chunk_p50_ms"] = statistics.median(lat)
            log(f"  transformer stream_audio (MMK_DECODE_KV=1) B={B}, {TF_KV_CHUNKS} chunks of"
                f" {STREAM_CHUNK} steps (its first {n_cmp} equal to 1000-step launches; real time"
                f" is {STREAM_CHUNK / 16:g} ms a chunk): {latency_line(lat)}")
    finally:
        del os.environ["MMK_DECODE_KV"]

    # generate B=16: one K6 launch
    p16 = prompts[TF_KV_B]
    net.generate((p16,), 8, temperature=TEMPERATURE, seed=SEED)
    before = td.decode_window.launches

    def run16():
        outs[16] = net.generate((p16,), TF_N16, temperature=TEMPERATURE, seed=SEED)[0]

    ms = cuda_ms(torch, run16, reps=3)
    med, spr = spread(ms)
    toks = outs[16][:, rf:]
    if toks.shape != (16, TF_N16) or int(toks.min()) < 0 or int(toks.max()) >= q:
        raise AssertionError(f"transformer generate B=16: bad tokens {tuple(toks.shape)}")
    if td.decode_window.launches - before != 3:
        raise AssertionError("transformer generate B=16 did not launch K6 once a call")
    with uncounted(td.decode_window):
        g16, parted = verify_window(torch, td, pack, p16, toks[:, :TF_N16], SEED, TEMPERATURE)
    gap = max(gap, g16)
    log(f"  transformer generate B=16 n={TF_N16} T={TEMPERATURE} (one K6 launch):"
        f" {16 * TF_N16 / (med / 1e3):.6g} samples/s ({1e3 * med / TF_N16:.2f} us a step; median"
        f" of 3: {med:.3f} ms, spread {spr:.3%}; {ms}); verified: max gap {g16:.3e}, {parted}"
        f" streams parted at near-ties")

    # the batched window route (no kernel), the yardstick transformer8l_win_b16
    net._window_loop(p16, 2, TEMPERATURE, SEED)
    win = {}

    def run_win():
        win["out"] = net._window_loop(p16, TF_N16, None, SEED)

    w_ms, w_spr = spread(cuda_ms(torch, run_win, reps=3))
    SUMMARY["win_b16_us"] = 1e3 * w_ms / TF_N16
    SUMMARY["win_b16_tokens"] = win["out"]
    if td.decode_window.launches - before != 3:
        raise AssertionError("the window route launched K6")
    with uncounted(td.decode_window):
        g, parted = verify_window(torch, td, pack, p16, win["out"][:, rf:].to(torch.int32), SEED,
                                  None)
    log(f"  transformer8l_win_b16: window route (_window_loop) B=16 x {TF_N16} argmax steps:"
        f" {1e3 * w_ms / TF_N16:.1f} us a step (median of 3, spread {w_spr:.3%};"
        f" {16 * TF_N16 / (w_ms / 1e3):.6g} samples/s); its tokens verified against K6's twin"
        f" (max gap {g:.3e}, {parted} parted)")

    route_sweep(torch, td, net, pack, rf, q)

    # a bank written by the port, reloaded through Checkpoint(...).network
    root = os.path.join(ROOT, "build", "chip_smoke_transformer")
    shutil.rmtree(root, ignore_errors=True)
    mmk.Checkpoint("transformer8l", 1, root).create(net)
    net2 = mmk.Checkpoint("transformer8l", 1, root, device="cuda").network.eval()
    live = net.state_dict()
    diff = [k for k, v in net2.state_dict().items() if not torch.equal(v, live[k])]
    if diff or type(net2) is not type(net):
        raise AssertionError(f"reloaded transformer differs: {type(net2).__name__}, {diff}")
    toks = net2.generate((p1,), TF_VERIFY)[0][:, rf:]
    g2, parted = verify_window(torch, td, td.transformer_weight_pack(net2), p1, toks, SEED, None)
    log(f"  epoch=1.ckpt of transformer8l reloaded with equal parameters; argmax generate"
        f" B=1 x {TF_VERIFY} from it verified (max gap {g2:.3e}, {parted} streams parted at"
        f" near-ties)")
    launches = {"transformer_decode_window": td.decode_window.launches,
                "transformer_decode_chunk": tk.decode_chunk.launches}
    log(f"  launches on the transformer serving path: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the transformer path was never launched: {launches}")
    return net, prompts, launches, max(gap, g2)


def route_sweep(torch, td, net, pack, rf, q):
    """K6 against the batched window route at each of ``TF_SWEEP_BATCHES``
    streams (argmax, ``TF_SWEEP_N`` steps a call): the measurement behind
    ``SimpleTransformer._K6_MAX_BATCH``.  Checks that ``generate`` takes the
    route the limit names at each B (its launches there are not the path's)."""
    for B in TF_SWEEP_BATCHES:
        prompt = make_prompt(torch, B, rf, q, seed=60 + B)
        with uncounted(td.decode_window):
            before = td.decode_window.launches
            net.generate((prompt,), 1, seed=SEED)
            if (td.decode_window.launches > before) != (B <= net._K6_MAX_BATCH):
                raise AssertionError(f"transformer generate B={B} took the wrong route")
            k_fn = lambda: td.decode_window(pack, prompt, TF_SWEEP_N, SEED, None)  # noqa: E731
            k_fn()
            k_ms, k_spr = spread(cuda_ms(torch, k_fn, reps=3))
        w_fn = lambda: net._window_loop(prompt, TF_SWEEP_N, None, SEED)  # noqa: E731
        w_fn()
        w_ms, w_spr = spread(cuda_ms(torch, w_fn, reps=3))
        route = "K6" if B <= net._K6_MAX_BATCH else "the window route"
        log(f"  transformer B={B} x {TF_SWEEP_N} argmax steps: K6 {1e3 * k_ms / TF_SWEEP_N:.1f} us"
            f" a step (spread {k_spr:.2%}), window route {1e3 * w_ms / TF_SWEEP_N:.1f} us a step"
            f" (spread {w_spr:.2%}; medians of 3); generate takes {route}")


def window_flops(pack, B):
    """f32 operations one K6 step needs.  Per stream, every layer but the
    last over rf rows: the eight d x d projections, the FFN, and both causal
    attentions' scores and sums over rf(rf+1)/2 (row, key) pairs.  The last
    layer's self and cross k|v over rf rows and the rest on the last row
    only, the one the head reads; then the head on that row."""
    d, ff, rf, L = pack.dim, pack.ff, pack.rf, pack.n_layers
    pairs = rf * (rf + 1) // 2
    layer = 2 * rf * (8 * d * d + 2 * d * ff) + 2 * 2 * 2 * pairs * d
    last = 2 * rf * 4 * d * d + 2 * (4 * d * d + 2 * d * ff) + 2 * 2 * 2 * rf * d
    return float(B) * ((L - 1) * layer + last + 2 * sum(i * o for i, o in pack.head_dims))


def kv_flops(pack, B, prior_t, n_steps):
    """f32 operations K7's steps 1 .. n_steps need.  Per stream, step and
    layer the eight d x d projections and the FFN of one row, and both
    attentions over the min(t, rf) valid slots; the head only where a step
    samples (t >= prior_t: earlier steps echo the prompt)."""
    d, ff, rf, L = pack.dim, pack.ff, pack.rf, pack.n_layers
    ts = range(1, n_steps + 1)
    slots = sum(min(t, rf) for t in ts)
    sampled = sum(1 for t in ts if t >= prior_t)
    layers = L * (n_steps * 2 * (8 * d * d + 2 * d * ff) + 2 * 2 * 2 * slots * d)
    return float(B) * (layers + sampled * 2 * sum(i * o for i, o in pack.head_dims))


def transformer_bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def window_bound(pack, B, n_steps):
    """(bound_ms, bound_by) of one K6 call: its operations, against the
    weights, the PE table, the window and the tokens read or written once."""
    nbytes = 4 * (pack.flat.numel() + pack.rf * pack.dim + B * (pack.rf + n_steps))
    return transformer_bound(window_flops(pack, B) * n_steps, nbytes)


def kv_bound(pack, B, prior_t, n_steps):
    """(bound_ms, bound_by) of one K7 call over steps 1 .. n_steps: its
    operations (over the rate of the pack's type), against the weights (at
    the pack's width), the PE rows, the prompt, the tokens and the f32 rings
    (read once, written once)."""
    ring = 4 * pack.n_layers * B * pack.rf * 4 * pack.dim
    nbytes = (pack.wbytes * pack.flat.numel() + 4 * (n_steps * pack.dim
                                                     + B * (prior_t + n_steps + 2)) + 2 * ring)
    return transformer_bound(kv_flops(pack, B, prior_t, n_steps), nbytes, peak_flops(pack))


def transformer_rows(torch, td, tk, net, prompts, launches, err):
    """Phase 5 rows of K6 and K7: kernel, plain twin (fewer steps, scaled),
    bound.  No single PyTorch call computes either decode."""
    pack = td.transformer_weight_pack(net)
    p1, p16 = prompts[1], prompts[TF_KV_B]
    rf = pack.rf
    C = STREAM_CHUNK

    def kv(prompt, n):
        return lambda: tk.decode_chunk(pack, prompt.t().contiguous(),
                                       tk.init_kv_state(pack, prompt), 1, n, TEMPERATURE, SEED)

    def kv_plain(prompt, n):
        return lambda: tk.decode_chunk_plain(pack, prompt.t().contiguous(),
                                             tk.init_kv_state(pack, prompt), 1, n, SEED,
                                             TEMPERATURE)

    calls = {
        "transformer_decode_window": (
            lambda: td.decode_window(pack, p1, TF_N, SEED, TEMPERATURE),
            lambda: td.decode_window_plain(pack, p1, rf, TF_PLAIN_STEPS, SEED, TEMPERATURE),
            TF_N / TF_PLAIN_STEPS, window_bound(pack, 1, TF_N),
            "mimikit_tpu/ops/pallas_decode.py:1248", f"B=1 steps={TF_N}"),
        "transformer_decode_chunk": (
            kv(p16, C), kv_plain(p16, TF_PLAIN_STEPS), C / TF_PLAIN_STEPS,
            kv_bound(pack, TF_KV_B, rf, C),
            "mimikit_tpu/ops/pallas_decode.py:1693", f"B={TF_KV_B} steps={C}"),
    }
    sources = {"transformer_decode_window": "mimikit_tpu_torch/csrc/transformer_decode.cu",
               "transformer_decode_chunk": "mimikit_tpu_torch/csrc/transformer_kv.cu"}
    rows = []
    for name, (kern, plain, scale, (bound, by), replaces, shape) in calls.items():
        kern()
        k_ms, k_spr = spread(cuda_ms(torch, kern, reps=3))
        p_ms = cuda_ms(torch, plain, reps=1)[0] * scale
        log(f"  {name} {shape}: kernel {k_ms:.4f} ms (median of 3, spread {k_spr:.2%}), plain twin"
            f" {p_ms:.3f} ms ({TF_PLAIN_STEPS} steps timed, scaled by {scale:g}), bound"
            f" {bound:.4f} ms by {by}; library: none (no single PyTorch call)")
        rows.append(dict(
            name=name, route="cuda", source=sources[name], replaces=replaces,
            launches=launches[name], max_abs_err=err[name], ms=k_ms, plain_ms=p_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
        ))
    return rows


def transformer_bench(torch, mmk, td, tk):
    """--bench: transformer8l's serving timings, K6 at B=16 against the
    batched window route, and K7 at B = 1, 4, 16 and 32."""
    net, prompts, launches, _ = transformer_path(torch, mmk, td, tk)
    pack = td.transformer_weight_pack(net)
    rf, q = TF_FULL["rf"], TF_FULL["q_levels"]
    p16 = prompts[TF_KV_B]
    n = TF_N16
    for name, fn in (("K6", lambda: td.decode_window(pack, p16, n, SEED, TEMPERATURE)),
                     ("batched window route", lambda: net._window_loop(p16, n, TEMPERATURE, SEED)),
                     ("K6", lambda: td.decode_window(pack, p16, n, SEED, TEMPERATURE)),
                     ("batched window route", lambda: net._window_loop(p16, n, TEMPERATURE, SEED))):
        fn()
        med, spr = spread(cuda_ms(torch, fn, reps=3))
        log(f"  transformer B=16 x {n} steps, {name}: {med:.3f} ms ({1e3 * med / n:.2f} us a step;"
            f" median of 3, spread {spr:.3%})")
    for B in (1, 4, 16, 32):
        prompt = make_prompt(torch, B, rf, q, seed=40 + B)

        def fn():
            return kv_run(torch, tk, pack, prompt, STREAM_CHUNK - rf + 1, STREAM_CHUNK,
                          TEMPERATURE, SEED)

        fn()
        med, spr = spread(cuda_ms(torch, fn, reps=3))
        bound, by = kv_bound(pack, B, rf, STREAM_CHUNK)
        log(f"  transformer decode_chunk B={B} steps={STREAM_CHUNK}: {med:.3f} ms"
            f" ({1e3 * med / STREAM_CHUNK:.2f} us a step; median of 3, spread {spr:.3%}); bound"
            f" {bound:.4f} ms by {by}")
    transformer_rows(torch, td, tk, net, prompts, launches, {k: 0.0 for k in launches})


# -- the bf16 routes: K1/K2 and K7 on bf16 weights, the window route in bf16 -----------

@contextlib.contextmanager
def env_set(**kv):
    """Set environment variables inside the block (the serving knobs)."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def versus(what, key16, key32, unit):
    """A line with a bf16 number beside the f32 one of the same run."""
    a, b = SUMMARY[key16], SUMMARY[key32]
    log(f"  {what}: bf16 {a:.3f} {unit} against f32 {b:.3f} {unit} ({a / b:.3f}x)")


def samplernn_bf16_path(torch, mmk, sd, net, p4, p256):
    """Phase 3 under ``MMK_PALLAS_BF16=1``: SampleRNN-3's main path
    (``main_path``: generate at B=4, decode_single's route, and B=256,
    decode_chunk's; stream_audio), every launch the bf16 instantiation; the
    B=256 output's first ``N_BF16_VERIFY`` steps verified against the bf16
    twin; each number beside the f32 run's.  Returns (launches, gap)."""
    for w in (sd.decode_single, sd.decode_chunk):
        w.launches = w.launches_bf16 = w.launches_cluster = 0
    with env_set(MMK_PALLAS_BF16="1"):
        outs = main_path(torch, mmk, net, p4, p256, label="_bf16")
    launches = {"decode_single_bf16": sd.decode_single.launches_bf16,
                "decode_chunk_bf16": sd.decode_chunk.launches_bf16}
    log(f"  launches on the bf16 serving path: {launches}, of which the cluster kernel"
        f" decode_single {sd.decode_single.launches_cluster}, decode_chunk"
        f" {sd.decode_chunk.launches_cluster}")
    if (launches["decode_single_bf16"] != sd.decode_single.launches
            or launches["decode_chunk_bf16"] != sd.decode_chunk.launches):
        raise AssertionError("the bf16 serving path launched the f32 instantiation")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the bf16 serving path was never launched: {launches}")
    if sd.decode_chunk.launches_cluster != sd.decode_chunk.launches:
        raise AssertionError("bf16 decode_chunk at B=256 did not take the cluster kernel")
    if sd.decode_single.launches_cluster != sd.decode_single.launches:
        raise AssertionError("bf16 decode_single at B=4 did not take the cluster kernel")
    launches["cluster"] = {"decode_single_bf16": sd.decode_single.launches_cluster,
                           "decode_chunk_bf16": sd.decode_chunk.launches_cluster}
    pack16 = sd.samplernn_weight_pack(net, torch.bfloat16)
    prior_t = p256.shape[1]
    with uncounted(sd.decode_single, sd.decode_chunk):
        gap, parted = verify(torch, sd, pack16, p256,
                             outs[256][:, prior_t : prior_t + N_BF16_VERIFY], SEED, TEMPERATURE)
    log(f"  generate_bf16 B=256 output, its first {N_BF16_VERIFY} steps verified against the bf16"
        f" twin: max gap {gap:.3e}, {parted} streams parted at near-ties")
    versus("SampleRNN-3 generate B=256 x 16384", "srnn_bf16_b256_ms", "srnn_b256_ms", "ms")
    versus("SampleRNN-3 generate B=4 x 4096", "srnn_bf16_b4_ms", "srnn_b4_ms", "ms")
    versus("SampleRNN-3 stream_audio chunk p50", "srnn_bf16_chunk_p50_ms", "srnn_chunk_p50_ms",
           "ms")
    versus("SampleRNN-3 stream_audio chunk p95", "srnn_bf16_chunk_p95_ms", "srnn_chunk_p95_ms",
           "ms")
    return launches, gap


def transformer_bf16_path(torch, mmk, td, tk, net, prompts):
    """Phase 3 under ``MMK_DECODE_BF16=1``: transformer8l's KV stream
    (``MMK_DECODE_KV=1``) at B=1 and 16, every launch K7's bf16
    instantiation, its first chunks equal to 1000-step launches and the
    B=16 stream's first 256 tokens verified against the bf16 twin; then the
    window route in bf16 at B=16 (``transformer8l_win_b16``).  Each number
    beside the f32 run's.  Returns (launches, gap)."""
    q, rf = TF_FULL["q_levels"], TF_FULL["rf"]
    expand = mmk.MuLawExpand(q)
    pack16 = td.transformer_weight_pack(net, torch.bfloat16)
    tk.decode_chunk.launches = tk.decode_chunk.launches_bf16 = 0
    gap = 0.0
    with env_set(MMK_DECODE_KV="1", MMK_DECODE_BF16="1"):
        for B in (1, TF_KV_B):
            lat, chunks = chunk_latencies(
                mmk.stream_audio(net, (prompts[B],), STREAM_CHUNK, temperature=TEMPERATURE,
                                 seed=SEED), TF_KV_CHUNKS)
            n_cmp = 2 * STREAM_CHUNK
            with uncounted(tk.decode_chunk):
                ref = kv_run(torch, tk, pack16, prompts[B], n_cmp, 1000, TEMPERATURE, SEED)
                if B == TF_KV_B:
                    gap, parted = verify_kv(torch, tk, pack16, prompts[B], ref[:, :256], SEED,
                                            TEMPERATURE)
                    log(f"  the bf16 KV stream B={B}: its first 256 tokens verified against the"
                        f" bf16 twin: max gap {gap:.3e}, {parted} streams parted at near-ties")
            got = np.concatenate(chunks, 1)
            if got.shape != (B, TF_KV_CHUNKS * STREAM_CHUNK) or not np.array_equal(
                    got[:, :n_cmp], expand(ref.cpu().numpy())):
                raise AssertionError(f"transformer bf16 KV stream B={B} is not chunk-invariant")
            SUMMARY[f"kv_bf16_b{B}_chunk_p50_ms"] = statistics.median(lat)
            log(f"  transformer stream_audio (MMK_DECODE_KV=1 MMK_DECODE_BF16=1) B={B},"
                f" {TF_KV_CHUNKS} chunks of {STREAM_CHUNK} steps (its first {n_cmp} equal to"
                f" 1000-step launches): {latency_line(lat)}")
            versus(f"transformer8l KV chunk p50 B={B}", f"kv_bf16_b{B}_chunk_p50_ms",
                   f"kv_b{B}_chunk_p50_ms", "ms")
    launches = {"transformer_decode_chunk_bf16": tk.decode_chunk.launches_bf16}
    log(f"  launches on the bf16 KV path: {launches}")
    if launches["transformer_decode_chunk_bf16"] != tk.decode_chunk.launches:
        raise AssertionError("the bf16 KV stream launched K7's f32 instantiation")
    if launches["transformer_decode_chunk_bf16"] == 0:
        raise AssertionError("the bf16 KV stream never launched K7")
    # the window route in bf16: a bf16 copy of the net, no kernel
    p16 = prompts[TF_KV_B]
    win = {}
    with env_set(MMK_DECODE_BF16="1"):
        net._window_loop(p16, 2, TEMPERATURE, SEED)

        def run_win():
            win["out"] = net._window_loop(p16, TF_N16, None, SEED)

        w_ms, w_spr = spread(cuda_ms(torch, run_win, reps=3))
    toks = win["out"][:, rf:]
    if toks.shape != (TF_KV_B, TF_N16) or int(toks.min()) < 0 or int(toks.max()) >= q:
        raise AssertionError(f"the bf16 window route: bad tokens {tuple(toks.shape)}")
    if len(set(toks[0].tolist())) < 2:
        raise AssertionError("the bf16 window route: constant argmax tokens")
    SUMMARY["win_bf16_b16_us"] = 1e3 * w_ms / TF_N16
    same = float((toks == SUMMARY["win_b16_tokens"][:, rf:]).float().mean())
    log(f"  transformer8l_win_b16 (MMK_DECODE_BF16=1): window route B=16 x {TF_N16} argmax steps"
        f" in bf16: {SUMMARY['win_bf16_b16_us']:.1f} us a step (median of 3, spread {w_spr:.3%});"
        f" {same:.1%} of its tokens equal the f32 route's")
    versus("transformer8l_win_b16 step", "win_bf16_b16_us", "win_b16_us", "us")
    return launches, gap


def bf16_rows(torch, sd, td, tk, net, p4, p256, tf_net, tf_prompts, launches, err):
    """Phase 5 rows of the bf16 instantiations at the bf16 main paths'
    shapes: K1-bf16 (decode_single B=4), K2-bf16 (decode_chunk B=256), K7-bf16
    (B=16, steps 1-1,600); each plain twin (the bf16 twin) over fewer steps,
    scaled; bounds with the weights at 2 bytes and the operations at the
    tensor cores' bf16 rate.  No single PyTorch call computes a decode."""
    rf = net.rf
    pack16 = sd.samplernn_weight_pack(net, torch.bfloat16)
    tpack16 = td.transformer_weight_pack(tf_net, torch.bfloat16)
    p16 = tf_prompts[TF_KV_B]
    C, n_twin = STREAM_CHUNK, SRN_PLAIN_STEPS
    n4 = p4.shape[1] + N_SMALL - rf
    calls = {
        "decode_single_bf16": (
            lambda: sd.decode_single(pack16, p4, N_SMALL, SEED, TEMPERATURE),
            lambda: sd.decode_plain(pack16, p4, sd.init_decode_state(net, p4), rf, n_twin,
                                    p4.shape[1], n_twin, SEED, TEMPERATURE),
            n4 / n_twin, decode_bound(pack16, 4, p4.shape[1], rf, n4, N_SMALL),
            k2_source(sd, pack16, 4), "mimikit_tpu/ops/pallas_decode.py:148",
            f"B=4 steps={n4}",
            lambda: sd.decode_single(pack16, p4, N_SMALL, SEED, TEMPERATURE, cl=0)),
        "decode_chunk_bf16": (
            lambda: sd.decode_chunk(pack16, p256, sd.init_decode_state(net, p256), rf,
                                    net._CHUNK, SEED, TEMPERATURE),
            lambda: sd.decode_plain(pack16, p256, sd.init_decode_state(net, p256), rf, n_twin, rf,
                                    n_twin, SEED, TEMPERATURE),
            net._CHUNK / n_twin,
            decode_bound(pack16, 256, p256.shape[1], rf, net._CHUNK, net._CHUNK),
            k2_source(sd, pack16, 256), "mimikit_tpu/ops/pallas_decode.py:868",
            f"B=256 steps={net._CHUNK}",
            lambda: sd.decode_chunk(pack16, p256, sd.init_decode_state(net, p256), rf,
                                    net._CHUNK, SEED, TEMPERATURE, cl=0)),
        "transformer_decode_chunk_bf16": (
            lambda: tk.decode_chunk(tpack16, p16.t().contiguous(), tk.init_kv_state(tpack16, p16),
                                    1, C, TEMPERATURE, SEED),
            lambda: tk.decode_chunk_plain(tpack16, p16.t().contiguous(),
                                          tk.init_kv_state(tpack16, p16), 1, TF_PLAIN_STEPS,
                                          SEED, TEMPERATURE),
            C / TF_PLAIN_STEPS, kv_bound(tpack16, TF_KV_B, TF_FULL["rf"], C),
            "mimikit_tpu_torch/csrc/transformer_kv.cu", "mimikit_tpu/ops/pallas_decode.py:1693",
            f"B={TF_KV_B} steps={C}", None),
    }
    rows = []
    with uncounted(sd.decode_single, sd.decode_chunk, tk.decode_chunk):
        for name, (kern, plain, scale, (bound, by), source, replaces, shape,
                   block) in calls.items():
            kern()
            k_ms, k_spr = spread(cuda_ms(torch, kern, reps=3))
            p_ms = cuda_ms(torch, plain, reps=1)[0] * scale
            b_ms = block_kernel_ms(torch, block)
            log(f"  {name} {shape}: kernel {k_ms:.4f} ms (median of 3, spread {k_spr:.2%}),"
                f" plain twin {p_ms:.3f} ms (fewer steps timed, scaled by {scale:g}), bound"
                f" {bound:.4f} ms by {by}; library: none (no single PyTorch call)"
                + (f"; the block kernel {b_ms:.4f} ms" if b_ms is not None else ""))
            rows.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=launches[name], max_abs_err=err[name], ms=k_ms, plain_ms=p_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                **({"cluster_launches": launches["cluster"][name]}
                   if name in launches.get("cluster", {}) else {}),
                **({"block_kernel_ms": b_ms} if b_ms is not None else {}),
            ))
    return rows


def block_kernel_ms(torch, block):
    """A K1 or K2 row's second time: ``block``, the same call on the block
    kernel (``cl=0``), median of 3 ms; None without one."""
    if block is None:
        return None
    block()
    return spread(cuda_ms(torch, block, reps=3))[0]


def k2_source(sd, pack, B):
    """The source of the kernel ``decode_single`` and ``decode_chunk`` launch
    B streams of ``pack``'s net with."""
    return ("mimikit_tpu_torch/csrc/samplernn_cluster.cu" if sd.cluster_size_for(pack, B)
            else "mimikit_tpu_torch/csrc/samplernn_decode.cu")


# -- JukeBox serving (the tier-pyramid kernel K8) and the mu-law pair (K10) -----------

def make_jukebox(mmk, torch, jbd, spec, seed, jitter=0.0):
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=spec["q_levels"],
                                                      mlp_dim=spec["mlp_dim"]))
    cfg = mmk.JukeBox.Config(
        io_spec=io, frame_sizes=spec["frame_sizes"], model_dim=spec["model_dim"],
        n_heads=spec["n_heads"], feedforward_dim=spec["feedforward_dim"],
        num_layers=spec["num_layers"], rf=spec["rf"], input_dropout=0.0)
    net = mmk.JukeBox.from_config(cfg, device="cuda", seed=seed).eval()
    if jitter:  # varied argmax trajectories, as make_net's
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g).to(p.device) * jitter)
    if not jbd.supports_kernel_decode(net):
        raise AssertionError("the tier-pyramid kernel's gate refused the net")
    return net


def pyramid_tf_scores(torch, jbd, pack, full, t, m, seed, temperature):
    """The plain twin's (m, B, Q) scores of positions t .. t+m-1 of ``full``
    (B, T): position p read from its lead window, full[p - W + 1 : p + 1]
    with the last slot the placeholder (0)."""
    from mimikit_tpu_torch.ops.noise import gumbel_noise
    from mimikit_tpu_torch.ops.temperature import row_temperatures

    B, W, Q = full.shape[0], pack.window, pack.q_levels
    wins = full.unfold(1, W, 1)[:, t - W + 1 : t + m - W + 1].clone()  # (B, m, W)
    wins[..., -1] = 0
    s = jbd.pyramid_scores(pack, wins.transpose(0, 1).reshape(m * B, W)).reshape(m, B, Q)
    temps = row_temperatures(temperature, B, full.device)
    if temps is not None:
        s = s / temps.tensor[:, None] + torch.stack(
            [gumbel_noise(seed, p, B, Q, full.device) for p in range(t, t + m)])
    return s


def verify_pyramid(torch, jbd, pack, prompt, toks, seed, temperature):
    """verify_tokens for the tier-pyramid kernel: ``prompt`` (B, prior_t >=
    W) and the kernel's tokens after it, the first at position prior_t."""
    prior_t, n = prompt.shape[1], toks.shape[1]

    def tf_scores(full, state, t, m):
        return pyramid_tf_scores(torch, jbd, pack, full, t, m, seed, temperature), None

    def free_run():
        return jbd.decode_pyramid_plain(pack, jbd.lead_window(prompt, pack.window), prior_t, n,
                                        seed, temperature)

    return verify_tokens(torch, prompt, toks, prior_t, tf_scores, free_run, tf_chunk=256)


def pyramid_run(torch, jbd, pack, prompt, n, chunk, temperature, seed, launch=None):
    """K8 over n steps after ``prompt`` (B, >= W) in launches of ``chunk``
    steps, the window carried on the card; returns the n tokens.  ``launch``
    (default ``decode_pyramid``, the route) takes decode_pyramid's
    arguments: ``jbd._launch`` for the block kernel, ``jbd._launch_cluster``
    for the cluster kernel whatever B."""
    launch = launch or jbd.decode_pyramid
    window = jbd.lead_window(prompt, pack.window)
    t0 = prompt.shape[1]
    return torch.cat([launch(pack, window, t0 + k, min(chunk, n - k), seed, temperature)
                      for k in range(0, n, chunk)], 1)


def cluster_barriers_per_step(pack):
    """The cluster kernel's exchanges a step (its source note): one for each
    tier's framed dense, six a layer, one for the bottom, one a head layer."""
    return pack.n_up * (1 + 6 * pack.n_layers) + 1 + len(pack.head_dims)


def jukebox_kernel_counts(jbd):
    """(block, cluster, group) launches so far."""
    f = jbd.decode_pyramid
    return (f.launches - f.launches_cluster - f.launches_group, f.launches_cluster,
            f.launches_group)


JB_NAMES = ("jukebox_decode_pyramid", "jukebox_decode_cluster", "jukebox_decode_group")


def check_jukebox(torch, mmk, jbd, spec, batches, n, chunk_lens, jitter):
    """Phase 2 for the three tier-pyramid kernels at one size: every B of
    ``batches`` through the route (the cluster kernel up to
    ``_K8_CLUSTER_MAX_B`` streams, the group kernel up to ``K8_GROUP_ROUTE``'s
    limit, the block kernel beyond), the cluster kernel at one stream more
    than the clusters that fit (clusters loop over streams), the group kernel
    at ``JB_GROUP_LOOP_B`` in groups of 2 (at full width one group more than
    the clusters that fit), each over several chunk lengths (the window carried; the
    tokens must not change), argmax and T=0.9; the cluster and group
    kernels' barriers a step as their block 0 counted them.  Returns
    {wrapper: largest score gap} under ``JB_NAMES``."""
    net = make_jukebox(mmk, torch, jbd, spec, seed=1, jitter=jitter)
    pack = jbd.jukebox_weight_pack(net)
    W, q = net._window_len(), spec["q_levels"]
    worst = {name: 0.0 for name in JB_NAMES}
    # the clusters that fit on the card at this net's shared memory
    one = make_prompt(torch, 1, W, q, seed=1)
    jbd._launch_cluster(pack, jbd.lead_window(one, W), W, 1, 0, None)
    loop_b = jbd.decode_pyramid.last_clusters + 1
    group_pairs = lambda *a: jbd._launch_group(*a, 8, 2)  # noqa: E731
    cases = ([(B, None) for B in batches] + [(loop_b, jbd._launch_cluster)]
             + [(JB_GROUP_LOOP_B, group_pairs)])
    for temp in (None, TEMPERATURE):
        mode = "argmax" if temp is None else f"T={temp}"
        for B, launch in cases:
            prompt = make_prompt(torch, B, W, q, seed=7 + B)
            before = jukebox_kernel_counts(jbd)
            runs = [pyramid_run(torch, jbd, pack, prompt, n, C, temp, 13, launch)
                    for C in chunk_lens]
            torch.cuda.synchronize()
            took = [a - b for a, b in zip(jukebox_kernel_counts(jbd), before)]
            if sum(1 for x in took if x) != 1:
                raise AssertionError(f"jukebox B={B} launched more than one kernel: {took}")
            kind = next(k for k, x in enumerate(took) if x)
            if launch is None and JB_NAMES[kind] != JB_NAMES[
                    ("block", "cluster", "group").index(jbd.route(pack, B)[0])]:
                raise AssertionError(f"jukebox decode_pyramid B={B} took the wrong kernel")
            name = JB_NAMES[kind]
            extra = ""
            if kind:
                last = n % chunk_lens[-1] or chunk_lens[-1]
                per_step = int(jbd.decode_pyramid.last_barriers) / last
                if per_step != cluster_barriers_per_step(pack):
                    raise AssertionError(f"the {name} kernel passed {per_step} cluster barriers a"
                                         f" step, not {cluster_barriers_per_step(pack)}")
                extra = (f"; {per_step:g} cluster barriers a step, clusters of"
                         f" {jbd.decode_pyramid.last_cluster_size},"
                         f" {jbd.decode_pyramid.last_clusters} fit")
                if kind == 2:
                    extra += f", groups of {jbd.decode_pyramid.last_streams}"
            for C, r in zip(chunk_lens[1:], runs[1:]):
                if not torch.equal(r, runs[0]):
                    raise AssertionError(f"jukebox {name} with chunk {C} changed the tokens")
            if temp is None and len(set(runs[0][0].tolist())) < 2:
                raise AssertionError("K8 argmax tokens are constant: the check is vacuous")
            gap, parted = verify_pyramid(torch, jbd, pack, prompt, runs[0], 13, temp)
            worst[name] = max(worst[name], gap)
            log(f"  jukebox {name} B={B} n={n} chunks {chunk_lens} {mode}: ok, max gap"
                f" {gap:.3e}, {parted} streams parted at near-ties{extra}")
    return worst


def check_row_temperatures(torch, mmk, sd, wd, td, tk, jbd, B=ROW_B, n=ROW_N):
    """Phase 2's per-row temperatures: every decode kernel and route (K1 and
    K2 on the cluster and the block kernel, f32 and bf16 packs; K4 and K5 on
    both WaveNet kernels; K6; K7 f32 and bf16; K8's cluster, group and block
    kernels) at the small widths decodes B streams at ``ROW_TEMPERATURES``
    (one a row, cycled).  The tokens must pass the teacher-forcing check
    against the plain twin at the same temperatures, and each row must equal,
    bit for bit, that row of the same decode (same seed) at its row's
    temperature for every row."""
    temps = tuple(ROW_TEMPERATURES[b % len(ROW_TEMPERATURES)] for b in range(B))

    def case(name, run, check):
        toks = run(temps)
        gap, parted = check(toks, temps)
        for v in sorted(set(temps)):
            rows = [b for b in range(B) if temps[b] == v]
            if not torch.equal(run(v)[rows], toks[rows]):
                raise AssertionError(f"{name}: rows {rows} at T={v} differ from the per-row"
                                     " decode")
        log(f"  {name} B={B} n={n} T={temps}: ok, max gap {gap:.3e}, {parted} streams parted at"
            f" near-ties; each row equals its row at its scalar temperature")

    net = make_net(mmk, torch, CLUSTER_MID, seed=1, jitter=0.5)
    rf, seed = net.rf, 19
    prompt = make_prompt(torch, B, 2 * rf, CLUSTER_MID["q_levels"], seed=21)
    prior_t = prompt.shape[1]
    for dt in (torch.float32, torch.bfloat16):
        pack = sd.samplernn_weight_pack(net, dt)
        twin = pack if dt == torch.bfloat16 else net
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        for cl in (sd.cluster_size_for(pack, B), 0):
            how = f"cluster kernel, {cl} blocks" if cl else "block kernel"
            check = lambda toks, t, twin=twin: verify(torch, sd, twin, prompt, toks, seed, t)
            case(f"decode_single{sfx} ({how})",
                 lambda t, pack=pack, cl=cl: sd.decode_single(pack, prompt, n, seed, t, cl=cl),
                 check)
            case(f"decode_chunk{sfx} ({how})",
                 lambda t, pack=pack, cl=cl: sd.decode_chunk(
                     pack, prompt, sd.init_decode_state(net, prompt), rf, prior_t + n - rf, seed,
                     t, cl=cl)[:, prior_t - rf :],
                 check)
    wn = make_wavenet(mmk, torch, wd, WN_SMALL, seed=1, jitter=0.3)
    pack = wd.wavenet_weight_pack(wn)
    prompt = make_prompt(torch, B, wn.rf + 8, WN_SMALL["q_levels"], seed=22)
    prior_t = prompt.shape[1]
    check = lambda toks, t: verify_wn(torch, wd, pack, prompt, toks, seed, t)  # noqa: E731
    for cl in (16, 0):
        how = f"cluster kernel, {cl} blocks" if cl else "block kernel"
        case(f"wavenet_decode_single ({how})",
             lambda t, cl=cl: wd.decode_single(pack, prompt, n, seed, t, cl=cl), check)
        case(f"wavenet_decode_chunk ({how})",
             lambda t, cl=cl: wd.decode_chunk(pack, prompt, wd.init_decode_state(pack, prompt), 1,
                                              prior_t + n - 1, seed, t, cl=cl)[:, prior_t - 1 :],
             check)
    tf = make_transformer(mmk, torch, td, TF_SMALL, seed=1, jitter=0.5)
    prompt = make_prompt(torch, B, 2 * TF_SMALL["rf"], TF_SMALL["q_levels"], seed=23)
    pack = td.transformer_weight_pack(tf)
    case("transformer_decode_window", lambda t: td.decode_window(pack, prompt, n, seed, t),
         lambda toks, t: verify_window(torch, td, pack, prompt, toks, seed, t))
    for dt in (torch.float32, torch.bfloat16):
        kv = td.transformer_weight_pack(tf, dt)
        case("transformer_decode_chunk" + ("_bf16" if dt == torch.bfloat16 else ""),
             lambda t, kv=kv: kv_run(torch, tk, kv, prompt, n, n + prompt.shape[1], t, seed),
             lambda toks, t, kv=kv: verify_kv(torch, tk, kv, prompt, toks, seed, t))
    jb = make_jukebox(mmk, torch, jbd, JB_SMALL, seed=1, jitter=0.3)
    pack = jbd.jukebox_weight_pack(jb)
    prompt = make_prompt(torch, B, jb._window_len(), JB_SMALL["q_levels"], seed=24)
    for name, launch in (("cluster", jbd._launch_cluster),
                         ("group", lambda *a: jbd._launch_group(*a, 8)),
                         ("block", jbd._launch)):
        case(f"jukebox {name} kernel",
             lambda t, launch=launch: pyramid_run(torch, jbd, pack, prompt, n, n, t, seed, launch),
             lambda toks, t: verify_pyramid(torch, jbd, pack, prompt, toks, seed, t))


def mulaw_near_integer(v, tol=1e-5):
    """Where the plain twin's value before truncation lies within rounding of
    an integer: |v - round(v)| <= tol * max(1, |v|) (f32 values reach 256,
    where one ulp is 1.5e-5)."""
    return (v - v.round()).abs() <= tol * v.abs().clamp_min(1.0)


def check_mulaw_ints(name, got, want, value):
    """Compress ints ``got`` against ``want``: equal, except by at most one
    where the plain value before truncation is near an integer; returns the
    count of such places and the largest |difference|."""
    diff = (got.long() - want.long()).abs()
    bad = (diff > 1) | ((diff == 1) & ~mulaw_near_integer(value))
    if bool(bad.any()):
        k = int(bad.nonzero()[0])
        raise AssertionError(f"{name}: int {int(got.reshape(-1)[k])} where {int(want.reshape(-1)[k])}"
                             f" (value before truncation {float(value.reshape(-1)[k])!r})")
    return int((diff == 1).sum()), int(diff.max()) if diff.numel() else 0


def check_mulaw(torch, mu):
    """Phase 2 for the mu-law kernel at a ragged small length and at the
    bench's 2,646,000 samples: compress ints by ``check_mulaw_ints``, expand
    within 1e-6; returns {wrapper: largest error}."""
    err = {"mulaw_compress": 0.0, "mulaw_expand": 0.0}
    for n in (3001, MULAW_N):
        g = torch.Generator().manual_seed(n)
        x = (torch.randn(n, generator=g) * 0.4).clamp(-1, 1).cuda()
        for q, c in ((256, 1.0), (32, 0.5)):
            got = mu.mulaw_compress(x, q, c)
            ties, d = check_mulaw_ints(f"mulaw_compress n={n} q={q} c={c}", got,
                                    mu.mulaw_compress_plain(x, q, c), mu.compress_value(x, q, c))
            toks = torch.randint(0, q, (n,), generator=g, dtype=torch.int32).cuda()
            e = close(f"mulaw_expand n={n} q={q} c={c}", mu.mulaw_expand(toks, q, c),
                      mu.mulaw_expand_plain(toks, q, c), 1e-6, 0.0)
            err["mulaw_compress"] = max(err["mulaw_compress"], float(d))
            err["mulaw_expand"] = max(err["mulaw_expand"], e)
            log(f"  mulaw n={n} q={q} c={c}: compress ok ({ties} ints one apart at near-integer"
                f" values), expand max |error| {e:.3e}")
    return err


def jukebox_path(torch, mmk, jbd):
    """Phase 3d: jukebox3 served at full width through the user entry points;
    returns (net, prompts, launches, {wrapper: gap of its verified outputs})."""
    net = make_jukebox(mmk, torch, jbd, JB_FULL, seed=0)
    W, q = net._window_len(), JB_FULL["q_levels"]
    log(f"  jukebox3: {net.n_parameters} parameters, window {W}")
    prompts = {B: make_prompt(torch, B, W, q, seed=60 + B) for B in JB_PATH_BATCHES}
    expand = mmk.MuLawExpand(q)
    pack = jbd.jukebox_weight_pack(net)
    for B in prompts:
        net.generate((prompts[B],), 16, temperature=TEMPERATURE, seed=SEED)  # lazy set-up
    gaps = {name: 0.0 for name in JB_NAMES}
    jbd.decode_pyramid.launches = jbd.decode_pyramid.launches_cluster = 0
    jbd.decode_pyramid.launches_group = 0
    outs = {}
    for B in JB_PATH_BATCHES:
        p = prompts[B]
        route, cl = jbd.route(pack, B)
        k = ("block", "cluster", "group").index(route)
        before = jukebox_kernel_counts(jbd)

        def run():
            outs[B] = net.generate((p,), JB_N, temperature=TEMPERATURE, seed=SEED)[0]

        ms = cuda_ms(torch, run, reps=3)
        med, spr = spread(ms)
        took = [a - b for a, b in zip(jukebox_kernel_counts(jbd), before)]
        if took != [3 if i == k else 0 for i in range(3)]:
            raise AssertionError(f"jukebox generate B={B} did not launch the {route} kernel once"
                                 f" a call: {took}")
        SUMMARY[f"jukebox3_b{B}_us"] = 1e3 * med / JB_N
        toks = outs[B][:, W:]
        if toks.shape != (B, JB_N) or int(toks.min()) < 0 or int(toks.max()) >= q:
            raise AssertionError(f"jukebox generate B={B}: bad tokens {tuple(toks.shape)}")
        if len(set(toks[0].tolist())) < 2:
            raise AssertionError(f"jukebox generate B={B}: constant sampled tokens")
        kind = {"cluster": f"cluster kernel, {cl} blocks",
                "group": f"group kernel, clusters of {cl}, groups of"
                         f" {jbd.decode_pyramid.last_streams}",
                "block": "block kernel"}[route]
        log(f"  jukebox generate B={B} n={JB_N} T={TEMPERATURE} ({kind}):"
            f" {B * JB_N / (med / 1e3):.6g} samples/s ({1e3 * med / JB_N:.2f} us a step;"
            f" median of 3: {med:.3f} ms, spread {spr:.3%}; {ms})")
        with uncounted(jbd.decode_pyramid):
            g, parted = verify_pyramid(torch, jbd, jbd.jukebox_weight_pack(net), p,
                                       toks[:, :JB_VERIFY], SEED, TEMPERATURE)
        name = JB_NAMES[k]
        gaps[name] = max(gaps[name], g)
        log(f"  its first {JB_VERIFY} tokens verified: max gap {g:.3e}, {parted} streams parted"
            f" at near-ties")

    # stream_audio B=1: one launch of the cluster kernel a chunk, the window
    # carried; noise keyed by position, so the stream is generate's decode with
    # the same seed
    before = jbd.decode_pyramid.launches_cluster
    lat, chunks = chunk_latencies(
        mmk.stream_audio(net, (prompts[1],), STREAM_CHUNK, temperature=TEMPERATURE, seed=SEED),
        JB_STREAM_CHUNKS)
    if jbd.decode_pyramid.launches_cluster - before < JB_STREAM_CHUNKS:
        raise AssertionError("the jukebox stream did not launch the cluster kernel once a chunk")
    SUMMARY["jukebox3_chunk_p50_ms"] = statistics.median(lat)
    n_cmp = (JB_N // STREAM_CHUNK) * STREAM_CHUNK
    got = np.concatenate(chunks, 1)
    if got.shape != (1, JB_STREAM_CHUNKS * STREAM_CHUNK) or not np.array_equal(
            got[:, :n_cmp], expand(outs[1][:, W : W + n_cmp].cpu().numpy())):
        raise AssertionError("jukebox stream_audio differs from the expanded generate output")
    log(f"  jukebox stream_audio B=1, {JB_STREAM_CHUNKS} chunks of {STREAM_CHUNK} steps (its first"
        f" {n_cmp} equal to the expanded generate output; real time is {STREAM_CHUNK / 16:g} ms a"
        f" chunk): {latency_line(lat)}")

    # the window route (no kernel), the yardstick of the port's jukebox3_win_b1
    p1 = prompts[1]
    net._window_loop(p1, 2, TEMPERATURE, SEED)
    before = jbd.decode_pyramid.launches
    win = {}

    def run_win():
        win["out"] = net._window_loop(p1, JB_WIN_STEPS, None, SEED)

    w_ms, w_spr = spread(cuda_ms(torch, run_win, reps=3))
    if jbd.decode_pyramid.launches != before:
        raise AssertionError("the window route launched K8")
    with uncounted(jbd.decode_pyramid):
        g, parted = verify_pyramid(torch, jbd, jbd.jukebox_weight_pack(net), p1,
                                   win["out"][:, W:].to(torch.int32), SEED, None)
    log(f"  jukebox window route (_window_loop) B=1 x {JB_WIN_STEPS} argmax steps:"
        f" {1e3 * w_ms / JB_WIN_STEPS:.1f} us a step (median of 3, spread {w_spr:.3%}; scaled to"
        f" {JB_N} steps {w_ms * JB_N / JB_WIN_STEPS:.1f} ms, {JB_N / (w_ms * JB_N / JB_WIN_STEPS / 1e3):.6g}"
        f" samples/s); its tokens verified against K8's twin (max gap {g:.3e}, {parted} parted)")

    # a bank written by the port, reloaded through Checkpoint(...).network
    root = os.path.join(ROOT, "build", "chip_smoke_jukebox")
    shutil.rmtree(root, ignore_errors=True)
    mmk.Checkpoint("jukebox3", 1, root).create(net)
    net2 = mmk.Checkpoint("jukebox3", 1, root, device="cuda").network.eval()
    live = net.state_dict()
    diff = [k for k, v in net2.state_dict().items() if not torch.equal(v, live[k])]
    if diff or type(net2) is not type(net):
        raise AssertionError(f"reloaded jukebox differs: {type(net2).__name__}, {diff}")
    before = jbd.decode_pyramid.launches_cluster
    toks = net2.generate((p1,), JB_VERIFY)[0][:, W:]
    if jbd.decode_pyramid.launches_cluster - before != 1:
        raise AssertionError("the reloaded jukebox did not decode through the cluster kernel")
    with uncounted(jbd.decode_pyramid):
        g2, parted = verify_pyramid(torch, jbd, jbd.jukebox_weight_pack(net2), p1, toks, SEED, None)
    log(f"  epoch=1.ckpt of jukebox3 reloaded with equal parameters; argmax generate B=1 x"
        f" {JB_VERIFY} from it verified (max gap {g2:.3e}, {parted} streams parted at near-ties)")
    launches = dict(zip(JB_NAMES, jukebox_kernel_counts(jbd)))
    log(f"  launches on the jukebox serving path: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the jukebox path was never launched: {launches}")
    gaps["jukebox_decode_cluster"] = max(gaps["jukebox_decode_cluster"], g2)
    return net, prompts, launches, gaps


def jukebox_route_sweep(torch, jbd, net, pack):
    """K8's cluster kernel at both cluster sizes, its group kernel at each of
    its sizes (from B = 16, past the cluster kernel's route) and its block
    kernel at each of ``JB_SWEEP_BATCHES`` streams (T=0.9, ``JB_SWEEP_N``
    steps a call, medians of 3): the measurement behind ``K8_CLUSTER_ROUTE``
    and ``K8_GROUP_ROUTE``.  Checks that ``generate`` takes the kernel and
    cluster size the route names at each B (its launches there are not the
    path's) and that the route's choice is within ``JB_SWEEP_TIE`` of this
    run's fastest at every B."""
    W, q = pack.window, JB_FULL["q_levels"]
    slower = []
    for B in JB_SWEEP_BATCHES:
        prompt = make_prompt(torch, B, W, q, seed=80 + B)
        route = jbd.route(pack, B)
        with uncounted(jbd.decode_pyramid):
            before = jukebox_kernel_counts(jbd)
            net.generate((prompt,), 1, seed=SEED)
            took = [a - b for a, b in zip(jukebox_kernel_counts(jbd), before)]
            kind = ("block", "cluster", "group")[took.index(1)] if took.count(1) == 1 else None
            got = (kind, None if kind == "block" else jbd.decode_pyramid.last_cluster_size)
            if got != route:
                raise AssertionError(f"jukebox generate B={B} took {got}, not {route}")
            launches = {("cluster", 16): lambda *a: jbd._launch_cluster(*a, cl=16),
                        ("cluster", 8): lambda *a: jbd._launch_cluster(*a, cl=8),
                        ("block", None): jbd._launch}
            if B > jbd._K8_CLUSTER_MAX_B:
                for cl in jbd.GROUP_SIZES:
                    launches[("group", cl)] = lambda *a, cl=cl: jbd._launch_group(*a, cl)
            times, fit = {}, {}
            for key, launch in launches.items():
                fn = lambda: launch(pack, jbd.lead_window(prompt, W), W,  # noqa: E731
                                    JB_SWEEP_N, SEED, TEMPERATURE)
                fn()
                fit[key] = (jbd.decode_pyramid.last_clusters, jbd.decode_pyramid.last_streams)
                times[key] = spread(cuda_ms(torch, fn, reps=3))
        fastest = min(times, key=lambda k: times[k][0])
        if times[route][0] > times[fastest][0] * (1 + JB_SWEEP_TIE):
            slower.append(B)
        us = {k: 1e3 * v[0] / JB_SWEEP_N for k, v in times.items()}
        cells = []
        for (kind, cl), v in times.items():
            where = "" if kind == "block" else f" at {cl} blocks"
            extra = "" if kind == "block" else f"; {fit[(kind, cl)][0]} clusters fit" + (
                f", groups of {fit[(kind, cl)][1]}" if kind == "group" else "")
            cells.append(f"{kind} kernel{where} {us[(kind, cl)]:.2f} ({v[1]:.2%}{extra})")
        log(f"  jukebox B={B} x {JB_SWEEP_N} steps, us a step (median of 3, spread): "
            + ", ".join(cells) + f"; generate takes the {route[0]} kernel"
            + ("" if route[1] is None else f" at {route[1]} blocks"))
    log(f"  K8_CLUSTER_ROUTE = {jbd.K8_CLUSTER_ROUTE}, K8_GROUP_ROUTE = {jbd.K8_GROUP_ROUTE}: "
        + (f"send B = {slower} to a choice slower than this run's fastest by more than"
           f" {JB_SWEEP_TIE:.0%}" if slower else
           f"send every B of the sweep to this run's fastest choice (within {JB_SWEEP_TIE:.0%})"))
    if slower:
        raise AssertionError(f"the jukebox route sends B = {slower} to a slower kernel")


def jukebox_bench(torch, jbd, net):
    """--bench: one cluster exchange's cost (``tools/cluster_exchange_probe.py``),
    the cluster size the route launches, the clusters that fit and the
    cluster barriers a step; then the route sweep."""
    from pathlib import Path

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import cluster_exchange_probe

    us = cluster_exchange_probe.measure(Path(ROOT))
    pack = jbd.jukebox_weight_pack(net)
    p = make_prompt(torch, 1, pack.window, JB_FULL["q_levels"], seed=61)
    n = 64
    jbd._launch_cluster(pack, jbd.lead_window(p, pack.window), pack.window, n, SEED, TEMPERATURE)
    plan = jbd.cluster_plan(pack)
    log(f"  cluster kernel: clusters of {jbd.K8_CLUSTER_SIZE} blocks (an exchange: push + barrier"
        f" {us[f'CL{jbd.K8_CLUSTER_SIZE} mode1']:.4f} us), {jbd.decode_pyramid.last_clusters}"
        f" clusters fit, {int(jbd.decode_pyramid.last_barriers) / n:g} cluster barriers a step,"
        f" {plan.smem_bytes} bytes of shared memory a block, rank 0 {plan.bytes(0, True)} bytes"
        f" resident and {plan.bytes(0, False)} streamed a step")
    jukebox_route_sweep(torch, jbd, net, pack)


def pyramid_flops(pack):
    """f32 operations one stream-step's output needs: every upper tier in
    full (framed dense, every layer's cross k|v, per layer q|k|v, the out,
    cross q and cross out products, the FFN, both causal attentions over
    n(n+1)/2 (row, key) pairs, the up-sampler), except that the last upper
    tier's last layer computes the self k|v of every frame and the rest for
    the last frame only, and its up-sampler the last chunk only; then the
    bottom conv and the head."""
    d, ff, L = pack.dim, pack.ff, pack.n_layers
    flops = 0
    for i in range(pack.n_up):
        f, n, t = pack.frames[i], pack.n_frames[i], pack.t_up[i]
        pairs = n * (n + 1) // 2
        last = i == pack.n_up - 1
        flops += 2 * n * f * d + L * 2 * n * d * 2 * d
        full_layer = 2 * n * d * 3 * d + 3 * 2 * n * d * d + 2 * 2 * n * d * ff + 2 * 2 * 2 * pairs * d
        last_layer = 2 * n * d * 2 * d + 4 * 2 * d * d + 2 * 2 * d * ff + 2 * 2 * 2 * n * d
        flops += (L - 1) * full_layer + (last_layer if last else full_layer)
        flops += 2 * d * d if last else 2 * n * d * t * d
    flops += 2 * pack.frames[-1] * d
    flops += 2 * sum(i * o for i, o in pack.head_dims[:-1]) + 2 * pack.head_dims[-1][0] * (
        pack.q_levels + 1)
    return float(flops)


def pyramid_bound(pack, B, n_steps):
    """(bound_ms, bound_by) of one K8 call: its operations, against the
    weights read once and the window (read and written) and tokens."""
    nbytes = 4 * (pack.flat.numel() + 2 * B * pack.window + B * n_steps)
    return transformer_bound(pyramid_flops(pack) * B * n_steps, nbytes)


def mulaw_bound(n):
    """(bound_ms, bound_by) of one mu-law call over n elements: 4 bytes read
    and 4 written an element, against ~20 operations an element."""
    t_ops, t_bytes = 20.0 * n / PEAK_F32_FLOPS, 8.0 * n / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def jukebox_rows(torch, jbd, mu, net, prompts, launches, err):
    """Phase 5 rows of K8's three kernels (the block kernel at B=64, the
    route's shape, the cluster kernel at B=1, the group kernel at B=16 with
    the block kernel's time on the same inputs, ``block_kernel_ms``), K10a
    and K10b: kernel, plain twin (K8's over JB_PLAIN_STEPS steps, scaled),
    bound; the block kernel also at B = 16, 32 and 64.  No single PyTorch
    call computes either function."""
    pack = jbd.jukebox_weight_pack(net)
    W, q = pack.window, JB_FULL["q_levels"]
    for B in (JB_B, 32, JB_WIDE):
        p = prompts.get(B, make_prompt(torch, B, W, q, seed=60 + B))
        fn = lambda: jbd._launch(pack, jbd.lead_window(p, W), W, JB_N, SEED,  # noqa: E731
                                 TEMPERATURE)
        fn()
        med, spr = spread(cuda_ms(torch, fn, reps=3))
        bound, by = pyramid_bound(pack, B, JB_N)
        log(f"  jukebox block kernel B={B} steps={JB_N}: {med:.3f} ms ({1e3 * med / JB_N:.2f} us a"
            f" step, {B * JB_N / (med / 1e3):.6g} samples/s; median of 3, spread {spr:.3%}); bound"
            f" {bound:.4f} ms by {by}")
    p1 = prompts[1]
    g = torch.Generator().manual_seed(5)
    # 8 inputs of each kind (85 MB), one after another through the graph's
    # calls: a call reads its input from HBM, not from the 50 MB L2 that the
    # call before left it in
    xs = [(torch.randn(MULAW_N, generator=g) * 0.4).clamp(-1, 1).cuda() for _ in range(8)]
    toks = [torch.randint(0, q, (MULAW_N,), generator=g, dtype=torch.int32).cuda()
            for _ in range(8)]
    per = 100  # mu-law calls a CUDA graph replays

    def cycled(fn, inputs):
        it = itertools.cycle(inputs)
        return lambda: fn(next(it))

    def events(fn, reps):
        fn()
        return cuda_ms(torch, fn, reps)

    def graph(fn, reps):
        return graph_ms(torch, fn, per, reps)

    plain = lambda: jbd.decode_pyramid_plain(pack, jbd.lead_window(p1, W), W,  # noqa: E731
                                             JB_PLAIN_STEPS, SEED, TEMPERATURE)
    pw = prompts.get(JB_WIDE, make_prompt(torch, JB_WIDE, W, q, seed=60 + JB_WIDE))
    pg = prompts.get(JB_B, make_prompt(torch, JB_B, W, q, seed=60 + JB_B))
    group_cl = jbd.route(pack, JB_B)[1]
    if jbd.route(pack, JB_B)[0] != "group":
        raise AssertionError(f"the group kernel's row: B={JB_B} is not on its route")
    calls = {
        "jukebox_decode_pyramid": (
            lambda: jbd._launch(pack, jbd.lead_window(pw, W), W, JB_N, SEED, TEMPERATURE),
            lambda: jbd.decode_pyramid_plain(pack, jbd.lead_window(pw, W), W, JB_PLAIN_STEPS,
                                             SEED, TEMPERATURE),
            events, JB_N / JB_PLAIN_STEPS, pyramid_bound(pack, JB_WIDE, JB_N),
            "mimikit_tpu/ops/pallas_decode.py:2386", "mimikit_tpu_torch/csrc/jukebox_decode.cu",
            "cuda", f"B={JB_WIDE} steps={JB_N}", "one call between CUDA events"),
        "jukebox_decode_cluster": (
            lambda: jbd._launch_cluster(pack, jbd.lead_window(p1, W), W, JB_N, SEED, TEMPERATURE),
            plain, events, JB_N / JB_PLAIN_STEPS, pyramid_bound(pack, 1, JB_N),
            "mimikit_tpu/ops/pallas_decode.py:2386", "mimikit_tpu_torch/csrc/jukebox_cluster.cu",
            "cuda", f"B=1 steps={JB_N}", "one call between CUDA events"),
        "jukebox_decode_group": (
            lambda: jbd._launch_group(pack, jbd.lead_window(pg, W), W, JB_N, SEED, TEMPERATURE,
                                      group_cl),
            lambda: jbd.decode_pyramid_plain(pack, jbd.lead_window(pg, W), W, JB_PLAIN_STEPS,
                                             SEED, TEMPERATURE),
            events, JB_N / JB_PLAIN_STEPS, pyramid_bound(pack, JB_B, JB_N),
            "mimikit_tpu/ops/pallas_decode.py:2386", "mimikit_tpu_torch/csrc/jukebox_group.cu",
            "cuda", f"B={JB_B} steps={JB_N}", "one call between CUDA events"),
        "mulaw_compress": (
            cycled(mu.mulaw_compress, xs), cycled(mu.mulaw_compress_plain, xs),
            graph, 1, mulaw_bound(MULAW_N), "mimikit_tpu/ops/pallas_kernels.py:58",
            "mimikit_tpu_torch/ops/mulaw.py", "triton", f"n={MULAW_N}",
            f"device time: {per} calls in a CUDA graph, 8 inputs in turn"),
        "mulaw_expand": (
            cycled(mu.mulaw_expand, toks), cycled(mu.mulaw_expand_plain, toks),
            graph, 1, mulaw_bound(MULAW_N), "mimikit_tpu/ops/pallas_kernels.py:94",
            "mimikit_tpu_torch/ops/mulaw.py", "triton", f"n={MULAW_N}",
            f"device time: {per} calls in a CUDA graph, 8 inputs in turn"),
    }
    rows = []
    with uncounted(mu.mulaw_compress, mu.mulaw_expand, jbd.decode_pyramid):
        timed = {name: (timer(kern, 3), timer(plain, 1)[0] * scale)
                 for name, (kern, plain, timer, scale, *_) in calls.items()}
        # the block kernel on the group row's inputs, in the same run
        block = lambda: jbd._launch(pack, jbd.lead_window(pg, W), W, JB_N, SEED,  # noqa: E731
                                    TEMPERATURE)
        block()
        b_ms = spread(cuda_ms(torch, block, reps=3))[0]
    for name, (_, _, _, scale, (bound, by), replaces, source, route, shape, how) in calls.items():
        (k_ms, k_spr), p_ms = spread(timed[name][0]), timed[name][1]
        extra = (f"; the block kernel on the same inputs {b_ms:.3f} ms"
                 if name == "jukebox_decode_group" else "")
        log(f"  {name} {shape}: kernel {k_ms:.5f} ms (median of 3, spread {k_spr:.2%}; {how}), plain"
            f" twin {p_ms:.5f} ms{f' ({JB_PLAIN_STEPS} steps timed, scaled by {scale:g})' if scale != 1 else ''},"
            f" bound {bound:.5f} ms by {by}; library: none (no single PyTorch call){extra}")
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces, launches=launches[name],
            max_abs_err=err[name], ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
            library_ms=None,
            **({"block_kernel_ms": b_ms} if name == "jukebox_decode_group" else {}),
        ))
    return rows


def mulaw_path(torch, mmk, mu, db, q):
    """Phase 4's tokens through K10: the training audio mu-law compressed on
    the card must give the dataset's tokens (``MuLawCompress``, the loader's
    spelling) under ``check_mulaw_ints``; expanded back it must equal the
    plain twin's expansion within 1e-6.  Returns the launches."""
    signal = np.asarray(db.signal[:], np.float32).reshape(-1)
    want = torch.from_numpy(np.asarray(mmk.MuLawCompress(q)(signal)))
    x = torch.from_numpy(signal).cuda()
    mu.mulaw_compress.launches = 0
    mu.mulaw_expand.launches = 0
    toks = mu.mulaw_compress(x, q)
    back = mu.mulaw_expand(toks, q)
    launches = {"mulaw_compress": mu.mulaw_compress.launches,
                "mulaw_expand": mu.mulaw_expand.launches}
    torch.cuda.synchronize()
    ties, _ = check_mulaw_ints("the training path's tokens", toks.cpu(), want,
                            mu.compress_value(x, q).cpu())
    e = close("the training path's expanded tokens", back, mu.mulaw_expand_plain(toks, q), 1e-6, 0.0)
    log(f"  {signal.size} samples mu-law compressed through K10a: the dataset's tokens ({ties} one"
        f" apart at near-integer values), expanded back through K10b (max |error| {e:.3e});"
        f" launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a mu-law kernel was never launched: {launches}")
    return launches


# -- the fused LSTM layer (training path) ---------------------------------------

def lstm_inputs(torch, T, B, D, H, seed):
    """Layer inputs x, Wi, Wh, b, h0, c0 and cotangents of h_all, h_T, c_T
    on the card, drawn from a seed."""
    g = torch.Generator().manual_seed(seed)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda()

    args = (mk(T, B, D), mk(D, 4 * H, scale=D ** -0.5), mk(H, 4 * H, scale=H ** -0.5),
            mk(4 * H, scale=0.1), mk(B, H, scale=0.3), mk(B, H, scale=0.3))
    return args, (mk(T, B, H), mk(B, H), mk(B, H))


def lstm_kernel_layer(torch, fl, args, cts):
    """The layer through the kernels: outputs and the six gradients."""
    ins = [a.clone().requires_grad_() for a in args]
    out = fl.fused_lstm_layer(*ins)
    return tuple(o.detach() for o in out), torch.autograd.grad(out, ins, cts)


def lstm_plain_layer(torch, fl, args, cts, forward=None, backward=None):
    """The same layer through the plain versions (or ``forward`` and
    ``backward`` in their place), on the same inputs: on bf16 streams the
    products outside the kernels take the bf16 values in f32 and round once,
    as ``_FusedLSTMLayer`` does."""
    forward = forward or fl.lstm_forward_plain
    backward = backward or fl.lstm_backward_plain
    x, Wi, Wh, b, h0, c0 = args
    T, B, D = x.shape
    dt = x.dtype
    x2 = x.reshape(T * B, D).float()
    xi = torch.addmm(b.float(), x2, Wi.float()).to(dt).reshape(T, B, -1)
    h_all, c_all, gates = forward(xi, Wh, h0, c0)
    dxi, dWh, dh0, dc0 = backward(*cts, gates, c_all, h_all, h0, c0, Wh)
    d2 = dxi.reshape(T * B, -1).float()
    grads = ((d2 @ Wi.float().t()).to(dt).reshape(T, B, D), (x2.t() @ d2).to(dt), dWh,
             d2.sum(0).to(dt), dh0, dc0)
    return (h_all, h_all[-1], c_all[-1]), grads


def close(name, k, p, atol, rtol):
    """max |k - p|, raising when it exceeds atol + rtol * max|p|."""
    err, scale = float((k - p).abs().max()), float(p.abs().max())
    if not err <= atol + rtol * scale:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} exceeds"
                             f" {atol:g} + {rtol:g} * {scale:.3e}")
    return err


def lstm_wrappers(fl, T, B, H, dtype):
    """(forward, backward, row-name suffix) of the kernels ``fl.lstm_route``
    names for the layer: the cluster wrappers, or the wide ones ("_wide")."""
    route = fl.lstm_route(B, T, H, dtype)
    if route == "cluster":
        return fl.lstm_forward, fl.lstm_backward, ""
    if route == "wide":
        return fl.lstm_forward_wide, fl.lstm_backward_wide, "_wide"
    raise AssertionError(f"(T, B, H) = ({T}, {B}, {H}) takes the scan: no kernel to check")


def launch_counts(fl, attr="launches"):
    return tuple(getattr(w, attr) for w in (fl.lstm_forward, fl.lstm_backward,
                                            fl.lstm_forward_wide, fl.lstm_backward_wide))


def check_wide_repeatable(torch, fl):
    """K3a-wide and K3b-wide where B takes more than one pass (the cases of
    LSTM_WIDE_B_SHAPES and LSTM_WIDE_BF16_B_SHAPES past 32 rows), each called
    WIDE_REPEATS times on the same inputs: every sum's order depends on H,
    the stream type and the cluster size only, so a pass that read shared
    memory the next one was writing shows as outputs that differ."""
    g = torch.Generator().manual_seed(17)
    for dt, shapes in ((torch.float32, LSTM_WIDE_B_SHAPES),
                       (torch.bfloat16, LSTM_WIDE_BF16_B_SHAPES)):
        for T, B, _, H in shapes:
            if B <= fl.WIDE_RP:
                continue
            xi, Wh, h0, c0, dh_all, dh_T, dc_T = (
                (torch.randn(*shape, generator=g) * sc).to("cuda", dt) for shape, sc in (
                    ((T, B, 4 * H), 0.5), ((H, 4 * H), H ** -0.5), ((B, H), 0.3),
                    ((B, H), 0.3), ((T, B, H), 0.1), ((B, H), 0.1), ((B, H), 0.1)))
            first = None
            for _ in range(WIDE_REPEATS):
                h_all, c_all, gates = fl.lstm_forward_wide(xi, Wh, h0, c0)
                out = (h_all, c_all, gates) + fl.lstm_backward_wide(
                    dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh)
                if first is None:
                    first = [o.clone() for o in out]
                elif not all(torch.equal(a, b) for a, b in zip(first, out)):
                    bad = [n for n, a, b in zip(("h_all", "c_all", "gates", "dxi", "dWh", "dh0",
                                                 "dc0"), first, out) if not torch.equal(a, b)]
                    raise AssertionError(f"wide LSTM (T, B, H) = ({T}, {B}, {H}) {dt}: repeated"
                                         f" calls differ in {bad}")
            log(f"  wide LSTM (T, B, H) = ({T}, {B}, {H}) {str(dt).split('.')[-1]}:"
                f" {WIDE_REPEATS} calls, the same bits")


def check_lstm(torch, fl, shapes):
    """Phase 2 for the LSTM kernels: the layer through the kernels' route (its
    wrappers' counters must rise, and no other's), then, on the cluster
    route, with the forward on each of its cluster sizes, against the plain
    versions; returns {wrapper: largest abs error}."""
    err = {}
    for T, B, D, H in shapes:
        fwd, bwd, sfx = lstm_wrappers(fl, T, B, H, torch.float32)
        args, cts = lstm_inputs(torch, T, B, D, H, seed=T + H)
        runs = [("route", lambda: lstm_kernel_layer(torch, fl, args, cts))]
        if not sfx:
            runs += [(f"forward on {cl}", lambda cl=cl: lstm_plain_layer(
                torch, fl, args, cts, functools.partial(fl.lstm_forward, cl=cl),
                fl.lstm_backward)) for cl in fl.FWD_CLUSTER_SIZES]
        p_out = p_grads = None
        for what, run in runs:
            before = launch_counts(fl)
            k_out, k_grads = run()
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(launch_counts(fl), before)]
            want = [0, 0, 1, 1] if sfx else [1, 1, 0, 0]
            if what == "route" and ran != want:
                raise AssertionError(f"fused LSTM layer ({T}, {B}, {H}): launches (forward,"
                                     f" backward, forward_wide, backward_wide) {ran}, expected"
                                     f" {want}")
            if p_out is None:
                p_out, p_grads = lstm_plain_layer(torch, fl, args, cts)
            f_err = [close(n, k, p, 1e-5, 1e-5)
                     for n, k, p in zip(("h_all", "h_T", "c_T"), k_out, p_out)]
            b_err = [close(n, k, p, 1e-5, 1e-4)
                     for n, k, p in zip(("dx", "dWi", "dWh", "db", "dh0", "dc0"), k_grads,
                                        p_grads)]
            for key, e in ((fwd.__name__, f_err), (bwd.__name__, b_err)):
                err[key] = max(err.get(key, 0.0), *e)
            log(f"  fused LSTM layer (T, B, H) = ({T}, {B}, {H}), {what}"
                f"{' (wide kernels)' if sfx else ''}: ok, max |error| outputs {max(f_err):.3e},"
                f" gradients {max(b_err):.3e} (dx, dWi, dWh, db, dh0, dc0:"
                f" {', '.join(f'{e:.2e}' for e in b_err)})")
    return err


LSTM_NAMES = ("h_all", "h_T", "c_T", "dx", "dWi", "dWh", "db", "dh0", "dc0")


def bf16_ulps(k, p):
    """(max |k - p| in bf16 ulps of p's scale, elements that differ): the
    ulp of the scale s = max|p| is 2^(floor(log2 s) - 7)."""
    k, p = k.float(), p.float()
    scale = float(p.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 2.0 ** -133
    return float((k - p).abs().max()) / ulp, int((k != p).sum())


def unrounded(torch, kernel):
    """``kernel`` (an LSTM wrapper) as the f32 instantiation on the bf16
    streams' values, its outputs rounded to bf16 where stored: a kernel that
    skips the rounding of h and dz, the control of the bf16 check."""
    def run(*streams):
        return tuple(o.to(torch.bfloat16) for o in kernel(*(v.float() for v in streams)))
    return run


def lstm_bf16_gaps(torch, fl, args, cts, control=False, fwd_cl=None):
    """The bf16 layer through the kernels of its route (with ``control``,
    through ``unrounded`` kernels; with ``fwd_cl``, the cluster forward on
    clusters of that size) against its bf16 twin on the same inputs: {tensor:
    (ulps, differing elements, elements)} for the three outputs and the six
    gradients, the kernels' (outputs, gradients) and the twin's."""
    T, B, _ = args[0].shape
    fwd, bwd, _ = lstm_wrappers(fl, T, B, args[2].shape[0], torch.bfloat16)
    if fwd_cl:
        k_out, k_grads = lstm_plain_layer(torch, fl, args, cts,
                                          functools.partial(fl.lstm_forward, cl=fwd_cl),
                                          fl.lstm_backward)
    elif control:
        with uncounted(fwd, bwd):
            k_out, k_grads = lstm_plain_layer(torch, fl, args, cts, unrounded(torch, fwd),
                                              unrounded(torch, bwd))
    else:
        k_out, k_grads = lstm_kernel_layer(torch, fl, args, cts)
    torch.cuda.synchronize()
    p_out, p_grads = lstm_plain_layer(torch, fl, args, cts)
    gaps = {n: (*bf16_ulps(k, p), p.numel())
            for n, k, p in zip(LSTM_NAMES, (*k_out, *k_grads), (*p_out, *p_grads))}
    return gaps, (k_out, k_grads), (p_out, p_grads)


def bf16_lstm_verdict(gaps, share_limit):
    """Raise unless every tensor lies within BF16_LSTM_ULPS ulps of its scale
    and the elements that differ stay within ``share_limit``: a share of the
    case's elements, or {tensor: share of its elements} (the wide kernels'
    BF16_LSTM_WIDE_SHARES); returns (largest ulps, share of the case's
    elements that differ)."""
    worst = max(g[0] for g in gaps.values())
    share = sum(g[1] for g in gaps.values()) / sum(g[2] for g in gaps.values())
    over = [n for n, g in gaps.items() if g[0] > BF16_LSTM_ULPS]
    if isinstance(share_limit, dict):
        wide = [f"{n} {gaps[n][1] / gaps[n][2]:.2%} (limit {lim:.0%})"
                for n, lim in share_limit.items() if gaps[n][1] / gaps[n][2] > lim]
        if over or wide:
            raise AssertionError(f"{over or 'no tensor'} beyond {BF16_LSTM_ULPS} ulps (largest"
                                 f" {worst:.3f}); {', '.join(wide) or 'no tensor'} past its"
                                 " share of elements that differ")
    elif over or share > share_limit:
        raise AssertionError(f"{over or 'no tensor'} beyond {BF16_LSTM_ULPS} ulps (largest"
                             f" {worst:.3f}); {share:.3%} of the elements differ (limit"
                             f" {share_limit:.0%})")
    return worst, share


def lstm_bf16_inputs(torch, T, B, D, H, seed):
    args, cts = lstm_inputs(torch, T, B, D, H, seed)
    return (tuple(a.to(torch.bfloat16) for a in args),
            tuple(c.to(torch.bfloat16) for c in cts))


def check_lstm_bf16(torch, fl, shapes, share_limit, seeds=(0,)):
    """Phase 2 for the bf16 instantiations: the layer through the bf16 kernels
    of its route (on the cluster route also with the forward on each cluster
    size) against its bf16 twin (``bf16_lstm_verdict`` at ``share_limit``),
    each shape at each input seed, then the control (``unrounded`` kernels)
    on the same inputs, which the check must refuse.  Returns
    {wrapper_bf16: largest abs error}."""
    err = {}
    for (T, B, D, H), seed in itertools.product(shapes, seeds):
        fwd, bwd, sfx = lstm_wrappers(fl, T, B, H, torch.bfloat16)
        args, cts = lstm_bf16_inputs(torch, T, B, D, H, seed=T + H + 1 + seed)
        for fwd_cl in (None, *(() if sfx else fl.FWD_CLUSTER_SIZES)):
            before = launch_counts(fl, "launches_bf16")
            gaps, (k_out, k_grads), (p_out, p_grads) = lstm_bf16_gaps(torch, fl, args, cts,
                                                                      fwd_cl=fwd_cl)
            ran = [a - b for a, b in zip(launch_counts(fl, "launches_bf16"), before)]
            if fwd_cl is None and ran != ([0, 0, 1, 1] if sfx else [1, 1, 0, 0]):
                raise AssertionError(f"fused LSTM layer bf16 ({T}, {B}, {H}): bf16 launches"
                                     f" (forward, backward, forward_wide, backward_wide) {ran}")
            worst, share = bf16_lstm_verdict(gaps, share_limit)
            for key, ks, ps in ((fwd.__name__ + "_bf16", k_out, p_out),
                                (bwd.__name__ + "_bf16", k_grads, p_grads)):
                err[key] = max(err.get(key, 0.0), *(float((k.float() - p.float()).abs().max())
                                                    for k, p in zip(ks, ps)))
            log(f"  fused LSTM layer bf16 (T, B, H) = ({T}, {B}, {H}) seed {seed},"
                f" {f'forward on {fwd_cl}' if fwd_cl else 'route'}"
                f"{' (wide kernels)' if sfx else ''}: ok, largest gap {worst:.3f}"
                f" bf16 ulps of a tensor's scale, {share:.3%} of the elements differ"
                f" ({', '.join(f'{n} {g[0]:.2f}/{g[1] / g[2]:.2%}' for n, g in gaps.items())})")
        bad, _, _ = lstm_bf16_gaps(torch, fl, args, cts, control=True)
        expect_caught(f"fused LSTM layer bf16 ({T}, {B}, {H}) seed {seed}",
                      lambda: bf16_lstm_verdict(bad, share_limit))
    return err


def train_net(mmk, seed, extractor=None, hidden_dim=None):
    """SampleRNN-3 (FULL) on the card, with ``hidden_dim`` in place of FULL's
    where given."""
    io = mmk.IOSpec.mulaw_io(
        mmk.IOSpec.MuLawIOConfig(q_levels=FULL["q_levels"], mlp_dim=FULL["mlp_dim"]),
        extractor=extractor,
    )
    cfg = mmk.SampleRNN.Config(frame_sizes=FULL["frame_sizes"],
                               hidden_dim=hidden_dim or FULL["hidden_dim"], io_spec=io)
    return mmk.SampleRNN.from_config(cfg, device="cuda", seed=seed)


def bf16_step_loss(torch, net, x, y):
    """The loss of one step of ``net`` under ``param_dtype="bfloat16"`` as
    TrainARMLoop runs it (bf16 copies of the f32 masters through
    ``functional_call`` inside ``precision.compute``, outputs back in f32),
    after its backward; every master gradient must be finite."""
    from torch.func import functional_call

    from mimikit_tpu_torch import precision

    net.zero_grad()
    params = precision.cast_parameters(net, torch.bfloat16)
    with precision.compute(torch.bfloat16):
        outputs, _ = functional_call(net, params, ((x,),))
    loss = net.config.io_spec.loss_fn(precision.cast_tree(outputs, torch.float32), (y,))["loss"]
    loss.backward()
    bad = [k for k, p in net.named_parameters() if not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise AssertionError(f"bf16 train step: gradients not finite in {bad}")
    return loss.item()


def check_train_step(torch, mmk, fl, hidden_dim=None, bf16=False):
    """One full-width train step's loss and gradients, kernels (on the card)
    against the plain versions (the same step on the CPU): loss within 1e-5
    relative, every gradient within 1e-5 + 1e-3 * max|plain|.  With
    ``hidden_dim`` the net's width is that (past FULL's, the wide kernels,
    whose counters must rise); with ``bf16`` also the same step under
    ``param_dtype="bfloat16"`` on the card (the bf16 kernels of the route),
    its loss within max(10 %, 5e-3) of the f32 CPU step's (the JAX package's
    bf16 criterion, tests/test_precision.py:193-205) and its gradients
    finite."""
    H = hidden_dim or FULL["hidden_dim"]
    net = train_net(mmk, seed=3, hidden_dim=H)
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, FULL["q_levels"], (TRAIN_B, net.rf + TRAIN_LEN), generator=g)
    y = torch.randint(0, FULL["q_levels"], (TRAIN_B, TRAIN_LEN), generator=g)
    before = launch_counts(fl) + launch_counts(fl, "launches_bf16")
    runs = []
    for n, dev in ((net, "cuda"), (copy.deepcopy(net).cpu(), "cpu")):
        outputs, _ = n((x.to(dev),))
        loss = n.config.io_spec.loss_fn(outputs, (y.to(dev),))["loss"]
        loss.backward()
        runs.append((loss.item(), {k: p.grad.cpu() for k, p in n.named_parameters()}))
    (lk, gk), (lp, gp) = runs
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"train step H={H}: loss kernels {lk!r}, plain {lp!r}")
    worst = max(close(f"grad {k}", gk[k], gp[k], 1e-5, 1e-3) for k in gp)
    log(f"  full train step B={TRAIN_B} x {TRAIN_LEN}, H={H}: ok, loss kernels {lk:.7f} / plain"
        f" {lp:.7f}, max |grad error| {worst:.3e} over {len(gp)} parameters")
    if bf16:
        l16 = bf16_step_loss(torch, net, x.cuda(), y.cuda())
        limit = max(0.1 * abs(lp), 5e-3)
        if not abs(l16 - lp) <= limit:
            raise AssertionError(f"bf16 train step H={H}: loss {l16!r} not within {limit:.4g}"
                                 f" of the f32 CPU step's {lp!r}")
        log(f"  full train step B={TRAIN_B} x {TRAIN_LEN}, H={H}, param_dtype=bfloat16 on the"
            f" card: loss {l16:.7f}, within {abs(l16 - lp):.4g} of the f32 CPU step's (limit"
            f" {limit:.4g}); gradients finite")
    ran = [a - b for a, b in zip(launch_counts(fl) + launch_counts(fl, "launches_bf16"),
                                 before)]
    log(f"  launches (forward, backward, forward_wide, backward_wide; f32 then bf16): {ran}")
    T = TRAIN_LEN // FULL["frame_sizes"][0]
    want = [[(i in (2, 3)) == (fl.lstm_route(TRAIN_B, T, H, dt) == "wide") for i in range(4)]
            for dt in (torch.float32, torch.bfloat16)]
    if [n > 0 for n in ran[:4]] != want[0] or (bf16 and [n > 0 for n in ran[4:]] != want[1]):
        raise AssertionError(f"train step H={H}: the LSTM calls did not take their route's"
                             f" kernels: {ran}")


def lstm_bound(T, B, H, backward, esize=4):
    """(bound_ms, bound_by) of one forward or backward call on ``esize``-byte
    streams: operations (recurrent products, the xi add and ~10 (forward) or
    ~20 (backward) elementwise operations a hidden unit) over the card's rate
    for the streams' type (f32 on the CUDA cores; bf16 on the tensor cores),
    against each input read once and each output written once over its
    memory rate.  The chain of T dependent steps is not in the bound."""
    H4 = 4 * H
    if not backward:
        flops = 2 * T * B * H * H4 + T * B * H4 + 10 * T * B * H
        nbytes = esize * (T * B * H4 + H * H4 + 2 * B * H + 2 * T * B * H + T * B * H4)
    else:
        flops = 2 * (2 * T * B * H4 * H) + 20 * T * B * H
        nbytes = esize * (3 * T * B * H + T * B * H4 + 4 * B * H + H * H4
                          + T * B * H4 + H * H4 + 2 * B * H)
    peak = PEAK_F32_FLOPS if esize == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lstm_timings(torch, fl, dtype, shapes=LSTM_SHAPES[1:]):
    """Per (T, B, D, H) of ``shapes`` (by default the training path's tier
    shapes), on ``dtype`` streams: kernel (those of the layer's route),
    plain twin and cuDNN ``nn.LSTM`` in the same dtype (the yardstick; the
    port never calls it) ms for the forward and for the backward (cuDNN:
    forward + backward; None where cuDNN refuses the dtype).  The rows' names
    end in ``_wide`` on the wide route, then ``_bf16`` on bf16 streams."""
    out = {}
    for T, B, D, H in shapes:
        fwd, bwd, route = lstm_wrappers(fl, T, B, H, dtype)
        sfx = route + ("_bf16" if dtype == torch.bfloat16 else "")
        args, cts = lstm_inputs(torch, T, B, D, H, seed=T)
        x, Wi, Wh, b, h0, c0 = (a.to(dtype) for a in args)
        cts = tuple(c.to(dtype) for c in cts)
        xi = torch.addmm(b.float(), x.reshape(T * B, D).float(), Wi.float()).to(dtype)
        xi = xi.reshape(T, B, -1)
        h_all, c_all, gates = fwd(xi, Wh, h0, c0)
        bw = (*cts, gates, c_all, h_all, h0, c0, Wh)
        ref = torch.nn.LSTM(D, H).cuda().to(dtype)
        xr = x.clone().requires_grad_()
        hc = (h0[None], c0[None])

        def cudnn_fb():
            y, _ = ref(xr, hc)
            y.backward(cts[0])

        row = {}
        for name, kern, plain, lib in (
            ("lstm_forward", lambda: fwd(xi, Wh, h0, c0),
             lambda: fl.lstm_forward_plain(xi, Wh, h0, c0), lambda: ref(xr, hc)),
            ("lstm_backward", lambda: bwd(*bw),
             lambda: fl.lstm_backward_plain(*bw), cudnn_fb),
        ):
            kern()
            k_ms, k_spr = spread(cuda_ms(torch, kern, reps=5))
            p_ms = cuda_ms(torch, plain, reps=1)[0]
            what = "forward" if name == "lstm_forward" else "forward+backward"
            try:  # the yardstick may refuse a dtype; the port never calls it
                lib()
            except RuntimeError as e:
                l_ms, lib_line = None, f"cuDNN nn.LSTM refuses {dtype}: {str(e)[:120]}"
            else:
                l_ms = spread(cuda_ms(torch, lib, reps=5))[0]
                lib_line = f"cuDNN nn.LSTM {what} {l_ms:.4f} ms"
            bound, by = lstm_bound(T, B, H, name == "lstm_backward", x.element_size())
            row[name + sfx] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                                   bound_by=by)
            log(f"  {name + sfx} (T, B, H) = ({T}, {B}, {H}): kernel {k_ms:.4f} ms (median of"
                f" 5, spread {k_spr:.2%}), plain twin {p_ms:.3f} ms, {lib_line}, bound"
                f" {bound:.4f} ms by {by}")
        out[T] = row
    return out


def lstm_fwd_sweep(torch, fl):
    """The forward on clusters of 8 and of 16 blocks at the training path's
    tier shapes, f32 and bf16 streams: ``lstm_forward``'s ms (median of 9
    calls a size, the sizes in turns so that a drift of the card's clock
    touches both, with the spread), the clusters that fit, and whether
    ``LSTM_FWD_ROUTE`` takes the faster size at every shape: the
    measurement behind the route."""
    slower = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for T, B, D, H in LSTM_SHAPES[1:]:
            args, _ = lstm_inputs(torch, T, B, D, H, seed=T)
            x, Wi, Wh, b, h0, c0 = (a.to(dtype) for a in args)
            xi = torch.addmm(b.float(), x.reshape(T * B, D).float(), Wi.float()).to(dtype)
            xi = xi.reshape(T, B, -1)
            route = fl.lstm_fwd_plan(B, H, x.element_size())[0]
            fns = {cl: functools.partial(fl.lstm_forward, xi, Wh, h0, c0, cl=cl)
                   for cl in fl.FWD_CLUSTER_SIZES}
            runs = {cl: [] for cl in fns}
            ms = {}
            with uncounted(fl.lstm_forward, fl.lstm_backward):
                for fn in fns.values():
                    fn()
                for _ in range(9):
                    for cl, fn in fns.items():
                        runs[cl] += cuda_ms(torch, fn, reps=1)
                for cl in fns:
                    rows = fl.lstm_fwd_plan(B, H, x.element_size(), cl)[1]
                    ms[cl], spr = spread(runs[cl])
                    fit = fl.fwd_clusters_that_fit(H, rows, cl, dtype)
                    log(f"  lstm_forward {dn} (T, B, H) = ({T}, {B}, {H}) on clusters of {cl}"
                        f" ({rows} rows, {-(-B // rows)} clusters, {fit} fit at once):"
                        f" {ms[cl]:.4f} ms (median of 9 in turns, spread {spr:.2%};"
                        f" {1e3 * ms[cl] / T:.3f} us a step)")
            if ms[route] > min(ms.values()):
                slower.append(f"{dn} T={T}")
    log(f"  LSTM_FWD_ROUTE = {fl.LSTM_FWD_ROUTE}: "
        + (f"takes the slower size at {slower}" if slower
           else "takes the faster size at every shape of the sweep"))


def lstm_bwd_sweep(torch, fl):
    """The backward walk on clusters of 8 and of 16 blocks at the training
    path's tier shapes, f32 and bf16 streams: ``lstm_backward``'s ms (median
    of 9) and a call's device time by kernel over 5 calls (the walk, dWh and
    its partial-tile sum; ``torch.profiler``), the clusters that fit, and
    whether ``LSTM_BWD_ROUTE`` takes the size whose walk is faster (dWh is
    the same kernel at both): the measurement behind the route."""
    from tools.lstm_bwd_split import by_kernel

    slower = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for T, B, D, H in LSTM_SHAPES[1:]:
            args, cts = lstm_inputs(torch, T, B, D, H, seed=T)
            x, Wi, Wh, b, h0, c0 = (a.to(dtype) for a in args)
            xi = torch.addmm(b.float(), x.reshape(T * B, D).float(), Wi.float()).to(dtype)
            h_all, c_all, gates = fl.lstm_forward(xi.reshape(T, B, -1), Wh, h0, c0)
            bw = (*(c.to(dtype) for c in cts), gates, c_all, h_all, h0, c0, Wh)
            route = fl.lstm_bwd_plan(B, H, x.element_size())[0]
            walk = {}
            with uncounted(fl.lstm_forward, fl.lstm_backward):
                for cl in fl.BWD_CLUSTER_SIZES:
                    fn = lambda: fl.lstm_backward(*bw, cl=cl)  # noqa: E731
                    fn()
                    rows = fl.lstm_backward.last_rows
                    ms, spr = spread(cuda_ms(torch, fn, reps=9))
                    parts = by_kernel(fn, reps=5)
                    walk[cl] = parts["walk"]
                    fit = fl.bwd_clusters_that_fit(H, rows, cl, dtype)
                    log(f"  lstm_backward {dn} (T, B, H) = ({T}, {B}, {H}) on clusters of {cl}"
                        f" ({rows} rows, {-(-B // rows)} clusters, {fit} fit at once):"
                        f" {ms:.4f} ms (median of 9, spread {spr:.2%}); a call by kernel"
                        f" (profiler, 5 calls): "
                        + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(parts.items()))
                        + f" ({1e3 * walk[cl] / T:.3f} us a step of the walk)")
            if walk[route] > min(walk.values()):
                slower.append(f"{dn} T={T}")
    log(f"  LSTM_BWD_ROUTE = {fl.LSTM_BWD_ROUTE}: "
        + (f"takes the size with the slower walk at {slower}" if slower
           else "takes the size with the faster walk at every shape of the sweep"))


def train_path(torch, mmk, fl, sd, mu):
    """Phase 4; returns the launches of its kernels (with ``mu``, the mu-law
    module, K10's on the training audio too)."""
    from scipy.io import wavfile
    from mimikit_tpu_torch.data import h5

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sr = 16000
    t = np.arange(sr * 60) / sr
    y = (0.6 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 587 * t)).astype(np.float32)
    wav = os.path.join(work, "s.wav")
    wavfile.write(wav, sr, (y * 32767).astype(np.int16))
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "db.h5"),
                           extractors=(mmk.Extractor.signal(sr=sr),))
    t0 = time.perf_counter()
    db = ds.create(mode="w")
    log(f"  DatasetConfig.create: {db.signal.shape[0]} samples in"
        f" {time.perf_counter() - t0:.2f} s (file layer: {h5.backend()})")
    mu_launches = mulaw_path(torch, mmk, mu, db, FULL["q_levels"]) if mu is not None else {}
    net = train_net(mmk, seed=0, extractor=ds.extractors[0])
    cfg = mmk.TrainARMConfig(
        root_dir=os.path.join(work, "tr"), batch_size=TRAIN_B, batch_length=TRAIN_LEN,
        tbptt_chunk_length=8 * TRAIN_LEN, max_epochs=TRAIN_EPOCHS,
        limit_train_batches=TRAIN_STEPS, every_n_epochs=2, MONITOR_TRAINING=False,
        trainer_kwargs={"data_seed": SEED},
    )
    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    for w in (fl.lstm_forward, fl.lstm_backward, sd.decode_single, sd.decode_chunk):
        w.launches = 0
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    means = [h["loss"] for _, h in loop.metrics.history]
    if len(means) != TRAIN_EPOCHS or not all(np.isfinite(means)) or not means[-1] < means[0]:
        raise AssertionError(f"epoch mean losses {means}: not finite and falling")
    log(f"  TrainARMLoop: {loop.global_step} steps over {TRAIN_EPOCHS} epochs in {wall:.2f} s"
        f" (first step's set-up included); epoch mean losses {means}")

    files = sorted(os.listdir(os.path.join(cfg.root_dir, loop.hash_)))
    ck = mmk.Checkpoint(loop.hash_, TRAIN_EPOCHS, cfg.root_dir, device="cuda")
    if os.path.basename(ck.os_path) not in files:
        raise AssertionError(f"no epoch={TRAIN_EPOCHS}.ckpt in {files}")
    net2 = ck.network
    live = net.state_dict()
    diff = [k for k, v in net2.state_dict().items() if not torch.equal(v, live[k])]
    if diff:
        raise AssertionError(f"reloaded parameters differ: {diff}")
    prompt = make_prompt(torch, 4, 2 * net2.rf, FULL["q_levels"], seed=9)
    toks = net2.eval().generate((prompt,), 1024)[0][:, prompt.shape[1]:]
    gap, parted = verify(torch, sd, net2, prompt, toks, SEED, None)
    log(f"  {files}: epoch={TRAIN_EPOCHS}.ckpt reloaded with equal parameters; argmax"
        f" generate B=4 x 1024 from it verified (max gap {gap:.3e}, {parted} streams"
        f" parted at near-ties)")
    launches = {w.__name__: w.launches
                for w in (fl.lstm_forward, fl.lstm_backward, sd.decode_single)}
    log(f"  launches on the training path: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the training path was never launched: {launches}")

    time_steps(torch, loop, "")
    monitored_train_path(torch, mmk, fl, sd, ds, cfg)
    bf16_launches = train_bf16_path(torch, mmk, fl, ds, cfg, means)
    wide_launches = {}
    for H, param_dtype in WIDE_TRAIN:
        wide_launches.update(wide_train_path(torch, mmk, fl, ds, cfg, H, param_dtype))
    return {**launches, **mu_launches, **bf16_launches, **wide_launches}


def monitored_train_path(torch, mmk, fl, sd, ds, cfg32):
    """Phase 4 as a user monitors training: SampleRNN-3 on the f32 run's data
    and steps for ``MONITOR_EPOCHS`` epochs with ``MONITOR_TRAINING``,
    ``OUTPUT_TRAINING="wav"``, ``ROW_TEMPERATURES`` (one an example, the
    recipe's), ``n_examples=4``, ``every_n_epochs=2``, ``loss_logs_file`` and
    prompts and outputs of ``MONITOR_SEC``: ``GenerateCallback`` writes
    ``outputs/epoch{e}_prm{i}.wav`` for the four prompts of each monitored
    epoch, launching K1 (its cluster kernel, B=4) while it runs, and the loss
    log reads back each epoch's loss; then one epoch of the same net under
    ``remat=True``: every loss finite, K3a launched twice a step for each
    tier (the forward recomputed in the backward), K3b once."""
    from mimikit_tpu_torch.data import h5

    net = train_net(mmk, seed=0, extractor=ds.extractors[0])
    cfg = copy.deepcopy(cfg32)
    cfg.root_dir = os.path.join(os.path.dirname(cfg32.root_dir), "tr_monitored")
    cfg.max_epochs, cfg.every_n_epochs, cfg.n_examples = MONITOR_EPOCHS, 2, 4
    cfg.MONITOR_TRAINING, cfg.OUTPUT_TRAINING = True, "wav"
    cfg.temperature = ROW_TEMPERATURES
    cfg.prompt_length_sec = cfg.outputs_duration_sec = MONITOR_SEC
    cfg.trainer_kwargs = {**cfg32.trainer_kwargs, "loss_logs_file": "loss.h5"}
    loop = mmk.TrainARMLoop.from_config(cfg, ds.get(mode="r"), net)
    gen_cb = next(cb for cb in loop.callbacks if isinstance(cb, mmk.GenerateCallback))
    calls = []
    epoch_end = gen_cb.on_train_epoch_end

    def timed(trainer, epoch):
        before = sd.decode_single.launches, sd.decode_single.launches_cluster
        t0 = time.perf_counter()
        epoch_end(trainer, epoch)
        torch.cuda.synchronize()
        calls.append((epoch, time.perf_counter() - t0, sd.decode_single.launches - before[0],
                      sd.decode_single.launches_cluster - before[1]))

    gen_cb.on_train_epoch_end = timed
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [h["loss"] for _, h in loop.metrics.history]
    if len(losses) != MONITOR_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"monitored epoch losses {losses}: not finite")
    run_dir = os.path.join(cfg.root_dir, loop.hash_)
    written = sorted(os.listdir(os.path.join(run_dir, "outputs")))
    monitored = [e for e in range(1, MONITOR_EPOCHS + 1) if e % cfg.every_n_epochs == 0]
    if len(written) != cfg.n_examples * len(monitored) or not all(
            any(name.startswith(f"epoch{e}_prm") and name.endswith(".wav") for name in written)
            for e in monitored):
        raise AssertionError(f"outputs/ holds {written}, not {cfg.n_examples} wav files an"
                             f" epoch of {monitored}")
    ran = [c for c in calls if c[2]]
    if [c[0] for c in ran] != monitored or any(c[3] != c[2] for c in ran):
        raise AssertionError(f"GenerateCallback's K1 launches by epoch {calls}: not one or more"
                             f" cluster launches at each of the epochs {monitored}")
    with h5.File(os.path.join(run_dir, "loss.h5"), "r") as f:
        logged = [float(f[str(e)]["loss"][0]) for e in range(1, MONITOR_EPOCHS + 1)]
    if logged != losses:
        raise AssertionError(f"the loss log holds {logged}, the run's losses are {losses}")
    n_gen = gen_cb.loop.n_steps
    for epoch, secs, n_k1, _ in ran:
        SUMMARY["monitor_s"] = secs
        log(f"  monitored training: GenerateCallback at epoch {epoch}, {cfg.n_examples} prompts"
            f" of {MONITOR_SEC} s and {n_gen} steps at T={ROW_TEMPERATURES}, in {secs:.3f} s"
            f" ({n_k1} K1 launches, all on the cluster kernel; the wav files written)")
    log(f"  monitored training: {loop.global_step} steps over {MONITOR_EPOCHS} epochs in"
        f" {wall:.2f} s; losses {losses}, read back from loss.h5 ({h5.backend()}); outputs"
        f" {written}")

    rcfg = copy.deepcopy(cfg32)
    rcfg.root_dir = os.path.join(os.path.dirname(cfg32.root_dir), "tr_remat")
    rcfg.max_epochs = 1
    rcfg.trainer_kwargs = {**cfg32.trainer_kwargs, "remat": True}
    rloop = mmk.TrainARMLoop.from_config(rcfg, ds.get(mode="r"), net)
    for w in (fl.lstm_forward, fl.lstm_backward):
        w.launches = 0
    rloop.run()
    torch.cuda.synchronize()
    rlosses = [h["loss"] for _, h in rloop.metrics.history]
    tiers = len(FULL["frame_sizes"]) - 1
    want = {"lstm_forward": 2 * tiers * rloop.global_step,
            "lstm_backward": tiers * rloop.global_step}
    got = {w.__name__: w.launches for w in (fl.lstm_forward, fl.lstm_backward)}
    if not all(np.isfinite(rlosses)) or got != want:
        raise AssertionError(f"remat epoch: losses {rlosses}, launches {got} (want {want})")
    log(f"  remat=True: {rloop.global_step} steps, losses {rlosses}; launches {got}: K3a twice"
        " a step for each tier")


def wide_train_path(torch, mmk, fl, ds, cfg32, H, param_dtype):
    """Phase 4 at a width past the cluster kernels: SampleRNN-3 with
    ``hidden_dim=H`` through ``TrainARMLoop`` for one epoch of TRAIN_STEPS
    steps (``param_dtype`` None: f32), on the training audio, the data_seed
    and the batches of the f32 run.  Every step's loss finite and the last
    below the first; every LSTM call on the wide kernels of the streams'
    dtype (their counters rise; the cluster kernels' and the other dtype's
    stay at 0) and no call of a plain version; the step timed and profiled.
    Returns the wide kernels' launches."""
    db = ds.get(mode="r")
    net = train_net(mmk, seed=0, extractor=ds.extractors[0], hidden_dim=H)
    cfg = copy.deepcopy(cfg32)
    sfx = f"_h{H}" + (f"_{param_dtype}" if param_dtype else "")
    cfg.root_dir = os.path.join(os.path.dirname(cfg32.root_dir), "tr" + sfx)
    cfg.max_epochs = 1
    if param_dtype:
        cfg.trainer_kwargs = {**cfg32.trainer_kwargs, "param_dtype": param_dtype}
    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    losses, step = [], loop.train_step

    def counted_step(*a):
        d, hidden = step(*a)
        losses.append(float(d["loss"]))
        return d, hidden

    loop.train_step = counted_step
    wrappers = (fl.lstm_forward, fl.lstm_backward, fl.lstm_forward_wide, fl.lstm_backward_wide)
    for w in wrappers:
        w.launches = w.launches_bf16 = 0
    plain = {"lstm_forward_plain": 0, "lstm_backward_plain": 0}
    real = {k: getattr(fl, k) for k in plain}

    def counting(name):
        def run(*a):
            plain[name] += 1
            return real[name](*a)
        return run

    for k in plain:
        setattr(fl, k, counting(k))
    try:
        t0 = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, f in real.items():
            setattr(fl, k, f)
    loop.train_step = step
    attr = "launches_bf16" if param_dtype else "launches"
    other = "launches" if param_dtype else "launches_bf16"
    got = {w.__name__ + ("_bf16" if param_dtype else ""): getattr(w, attr) for w in wrappers[2:]}
    stray = [getattr(w, a) for w in wrappers for a in (attr, other)
             if not (w in wrappers[2:] and a == attr)]
    log(f"  TrainARMLoop SampleRNN-3 hidden_dim={H} ({param_dtype or 'float32'}):"
        f" {loop.global_step} steps in {wall:.2f} s (first step's set-up included); step losses"
        f" {losses}; wide launches {got}, other LSTM launches {sum(stray)}, plain-version calls"
        f" {plain}")
    if (len(losses) != TRAIN_STEPS or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        raise AssertionError(f"hidden_dim={H}: step losses {losses} not finite and falling")
    if min(got.values()) == 0 or sum(stray) or sum(plain.values()):
        raise AssertionError(f"hidden_dim={H}: not every LSTM call ran the wide kernels: {got},"
                             f" {sum(stray)} other launches, plain calls {plain}")
    time_steps(torch, loop, sfx)
    return got


def time_steps(torch, loop, label):
    """The train step as the loop runs it (gather + step) over TBPTT chunks:
    median of 3 windows of TRAIN_STEPS steps (CUDA events), then one window
    profiled; the median goes to SUMMARY["train_step{label}_ms"]."""
    def window():
        hidden = None
        for k, (inputs, targets) in enumerate(loop._batches()):
            if k == TRAIN_STEPS:
                break
            _, hidden = loop.train_step(inputs, targets, hidden)

    window()
    ms = [w / TRAIN_STEPS for w in cuda_ms(torch, window, reps=3)]
    med, spr = spread(ms)
    SUMMARY[f"train_step{label}_ms"] = med
    log(f"  train step{label} B={TRAIN_B} x {TRAIN_LEN}: {TRAIN_B * TRAIN_LEN / (med / 1e3):.6g}"
        f" samples/s (median of 3 windows of {TRAIN_STEPS} steps: {med:.4f} ms/step,"
        f" spread {spr:.3%}; {ms})")
    profile_steps(torch, window)


def train_bf16_path(torch, mmk, fl, ds, cfg32, means32):
    """Phase 4 under ``trainer_kwargs={"param_dtype": "bfloat16"}``: the same
    net, data_seed, epochs and steps as the f32 run.  Every master parameter
    and the optimizer state stay f32; every LSTM call is the bf16
    instantiation (no f32 K3 launch in the run); the epoch mean losses are
    finite and falling, the last within max(10 %, 5e-3) of the f32 run's (the
    JAX package's criterion, tests/test_precision.py:193-205); the step is
    timed and profiled beside the f32 one.  Returns the bf16 launches."""
    db = ds.get(mode="r")
    net = train_net(mmk, seed=0, extractor=ds.extractors[0])
    cfg = copy.deepcopy(cfg32)
    cfg.root_dir = os.path.join(os.path.dirname(cfg32.root_dir), "tr_bf16")
    cfg.trainer_kwargs = {**cfg32.trainer_kwargs, "param_dtype": "bfloat16"}
    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    for w in (fl.lstm_forward, fl.lstm_backward):
        w.launches = w.launches_bf16 = 0
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    means = [h["loss"] for _, h in loop.metrics.history]
    if len(means) != TRAIN_EPOCHS or not all(np.isfinite(means)) or not means[-1] < means[0]:
        raise AssertionError(f"bf16 epoch mean losses {means}: not finite and falling")
    limit = max(0.1 * abs(means32[-1]), 5e-3)
    if not abs(means[-1] - means32[-1]) <= limit:
        raise AssertionError(f"bf16 last epoch mean loss {means[-1]} is not within {limit:.4g}"
                             f" of the f32 run's {means32[-1]}")
    kinds = {p.dtype for p in net.parameters()} | {
        v.dtype for st in loop.opt.adam.state.values() for v in st.values()
        if isinstance(v, torch.Tensor) and v.is_floating_point()}
    if kinds != {torch.float32}:
        raise AssertionError(f"bf16 training: master parameters or optimizer state in {kinds}")
    launches = {"lstm_forward_bf16": fl.lstm_forward.launches_bf16,
                "lstm_backward_bf16": fl.lstm_backward.launches_bf16}
    f32 = fl.lstm_forward.launches + fl.lstm_backward.launches
    log(f"  TrainARMLoop (param_dtype=bfloat16): {loop.global_step} steps over {TRAIN_EPOCHS}"
        f" epochs in {wall:.2f} s; epoch mean losses {means} (f32 run: {means32}; last within"
        f" {abs(means[-1] - means32[-1]):.4g} of it, limit {limit:.4g}); master parameters and"
        f" optimizer state f32; launches {launches}, f32 K3 launches {f32}")
    if f32 or min(launches.values()) == 0:
        raise AssertionError(f"the bf16 training path did not run only the bf16 K3: {launches},"
                             f" {f32} f32 launches")
    time_steps(torch, loop, "_bf16")
    versus(f"SampleRNN-3 train step B={TRAIN_B} x {TRAIN_LEN}", "train_step_bf16_ms",
           "train_step_ms", "ms")
    return launches


def profile_steps(torch, window):
    """Device time by kernel over one window of train steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or "#" in e.key:
            continue  # a host op or an annotation: its kernels are rows of their own
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"  profile of one window ({TRAIN_STEPS} steps): kernels {total / 1e3:.3f} ms of"
        f" {wall_us / 1e3:.3f} ms wall (profiler on; idle share {1 - total / wall_us:.1%})")
    for dev, key, count in rows[:16]:
        log(f"    {dev / 1e3 / TRAIN_STEPS:9.4f} ms/step  {100 * dev / total:5.1f}%"
            f"  x{count // TRAIN_STEPS:<3d} {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true", help="phases 1-2 at the small size only")
    mode.add_argument("--bench", action="store_true",
                      help="phase 1, the timings and phase 4; no kernel checks")
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mimikit_tpu_torch as mmk
    from mimikit_tpu_torch.ops import categorical as cat
    from mimikit_tpu_torch.ops import fused_lstm as fl
    from mimikit_tpu_torch.ops import jukebox_decode as jbd
    from mimikit_tpu_torch.ops import mulaw as mu
    from mimikit_tpu_torch.ops import samplernn_decode as sd
    from mimikit_tpu_torch.ops import transformer_decode as td
    from mimikit_tpu_torch.ops import transformer_kv as tk
    from mimikit_tpu_torch.ops import wavenet_decode as wd

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import launch_floor  # the empty kernel timed beside K9

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 -------------------------------------------------------------
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" python {sys.version.split()[0]}")
    def timed_build(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    t = time.perf_counter()
    # (source, the holder of its compiler output, its build)
    sources = ((sd.SOURCE, sd._Kernel, sd.build_kernel),
               (sd.CLUSTER_SOURCE, sd._ClusterKernel, sd.build_cluster_kernel),
               (fl.SOURCE, fl._Kernel, fl.build_lstm_kernel),
               (wd.SOURCE, wd._Kernel, wd.build_kernel),
               (wd.CLUSTER_SOURCE, wd._ClusterKernel, wd.build_cluster_kernel),
               (td.SOURCE, td._Kernel, td.build_kernel),
               (tk.SOURCE, tk._Kernel, tk.build_kernel),
               (jbd.SOURCE, jbd._Kernel, jbd.build_kernel),
               (jbd.CLUSTER_SOURCE, jbd._ClusterKernel, jbd.build_cluster_kernel),
               (jbd.GROUP_SOURCE, jbd._GroupKernel, jbd.build_group_kernel),
               (cat.SOURCE, cat._Kernel, cat.build_kernel),
               (launch_floor.SOURCE, launch_floor._Kernel, launch_floor.build_kernel))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, started together
        builds = [(src, held, pool.submit(timed_build, b)) for src, held, b in sources]
        builds = [(src, held, f.result()) for src, held, f in builds]
    for src, held, build_s in builds:
        for line in held.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
        log(f"  built {src.name} for sm_90a in {build_s:.1f} s")
    log(f"  the {len(sources)} builds took {time.perf_counter() - t:.1f} s")
    sass_check([(src, build()) for src, _, build in sources if src.parent.name == "csrc"])
    t = time.perf_counter()
    mu.mulaw_expand(mu.mulaw_compress(torch.zeros(8).cuda()))  # compiles the Triton mu-law pair
    torch.cuda.synchronize()
    log(f"  compiled the Triton mu-law kernel (ops/mulaw.py) in {time.perf_counter() - t:.1f} s")

    if args.bench:
        bench(torch, mmk, sd, fl)
        wavenet_bench(torch, mmk, wd, cat)
        transformer_bench(torch, mmk, td, tk)
        jb_net, jb_prompts, jb_launches, _ = jukebox_path(torch, mmk, jbd)
        jukebox_bench(torch, jbd, jb_net)
        jukebox_rows(torch, jbd, mu, jb_net, jb_prompts,
                     {**jb_launches, "mulaw_compress": 0, "mulaw_expand": 0},
                     {**{name: 0.0 for name in JB_NAMES}, "mulaw_compress": 0.0,
                      "mulaw_expand": 0.0})
        log(card)
        return 0

    # -- phase 2 -------------------------------------------------------------
    log(f"phase 2: each kernel against its plain twin (at {time.perf_counter() - t_start:.1f} s)")
    t_mark = [time.perf_counter()]

    def stamp(what):
        now = time.perf_counter()
        log(f"  [{what}: {now - t_mark[0]:.1f} s]")
        t_mark[0] = now

    err = check_kernels(torch, mmk, sd, SMALL, 4, 64, 300, (300 + 16, 7, 64), jitter=0.5)
    err.update(check_kernels(torch, mmk, sd, SMALL, 4, 64, 300, (300 + 16, 7, 64), jitter=0.5,
                             bf16=True, control=True))
    err = merge_max(err, check_cluster(torch, mmk, sd, CLUSTER_MID, (4, K2_RAGGED_B), 200,
                                       (200 + 16, 7, 64), jitter=0.5, sizes=sd.CLUSTER_SIZES))
    # (its gaps are logged, not the row's: the jittered small net's scores run to ~1e6)
    check_cluster(torch, mmk, sd, CLUSTER_MID, (4, K2_RAGGED_B), 200, (200 + 16, 7, 64),
                  jitter=0.5, bf16=True, sizes=sd.CLUSTER_SIZES, control=True)
    stamp("SampleRNN decode, small, f32 and bf16 (the block kernel, the cluster kernel)")
    err.update(check_lstm(torch, fl, LSTM_SHAPES[:1]))
    err.update(check_lstm_bf16(torch, fl, LSTM_SHAPES[:1], BF16_LSTM_SHARE[0], seeds=range(4)))
    err.update(check_wavenet(torch, mmk, wd, WN_SMALL, WN_SMALL_B, 40, 300, (300 + 15, 7, 64),
                             jitter=0.3))
    err = merge_max(err, check_wavenet_cluster(torch, mmk, wd, WN_SMALL, (3, 37), 200,
                                               (215, 64), jitter=0.3))
    err.update(check_categorical(torch, cat))
    stamp("LSTM, WaveNet and the sampler, small")
    err.update(check_transformer(torch, mmk, td, tk, TF_SMALL, 200, TF_WIN_BATCHES,
                                 TF_KV_BATCHES, (200 + 15, 7, 64), jitter=0.5))
    err.update(check_transformer(torch, mmk, td, tk, TF_SMALL, 150, (), TF_KV_BATCHES,
                                 (150 + 15, 7, 64), jitter=0.5, bf16=True, control=True))
    err = merge_max(err, check_transformer(torch, mmk, td, tk, TF_SMALL_LONG, 100, (1, 2), (1, 16),
                                           (100 + 15, 7, 64), jitter=0.5))
    stamp("K6 and K7, small, f32 and bf16")
    err.update(check_jukebox(torch, mmk, jbd, JB_SMALL, JB_CHECK_BATCHES, 200,
                             (200 + 15, 7, 64), jitter=0.3))
    err.update(check_mulaw(torch, mu))
    stamp("K8 and K10, small")
    check_row_temperatures(torch, mmk, sd, wd, td, tk, jbd)
    stamp("per-row temperatures through every decode kernel and route, small")
    if args.quick:
        log(json.dumps({"ok": True, "quick": True, "max_err": err}))
        return 0
    err_full = check_kernels(torch, mmk, sd, FULL, 4, 256, 2048, (2048 + 32, 700, 1600),
                             jitter=0.0)
    stamp("SampleRNN decode, full width, f32")
    err_full.update(check_kernels(torch, mmk, sd, FULL, 4, 256, 1024, (1024 + 32, 700),
                                  jitter=0.0, bf16=True))
    for bf16 in (False, True):
        err_full = merge_max(err_full, check_cluster(torch, mmk, sd, FULL, (K2_RAGGED_B,), 512,
                                                     (512 + 32, 100), jitter=0.0, bf16=bf16))
        # the block kernel, which K2_CLUSTER_ROUTE leaves the batches past its limits
        err_full = merge_max(err_full, check_cluster(torch, mmk, sd, FULL, (256,), 512,
                                                     (512 + 32, 100), jitter=0.0, bf16=bf16,
                                                     sizes=(0,)))
    stamp("SampleRNN decode, full width, bf16; the cluster kernel at a ragged B, the block"
          " kernel at B=256")
    err_full.update(check_lstm(torch, fl, LSTM_SHAPES[1:]))
    err_full.update(check_lstm_bf16(torch, fl, LSTM_SHAPES[1:], BF16_LSTM_SHARE[1]))
    err_full.update(check_wavenet(torch, mmk, wd, WN_FULL, WN_SMALL_B, 256, 256, (1287, 500),
                                  jitter=0.0))
    err_full = merge_max(err_full, check_wavenet_cluster(torch, mmk, wd, WN_FULL,
                                                         WN_CLUSTER_BATCHES, 256, (1287, 500),
                                                         jitter=0.0))
    stamp("LSTM and WaveNet, full width")
    err_full.update(check_transformer(torch, mmk, td, tk, TF_FULL, 128, TF_WIN_BATCHES,
                                      TF_KV_BATCHES, (128 + 63, 100), jitter=0.0))
    stamp("K6 and K7, full width, f32")
    err_full.update(check_transformer(torch, mmk, td, tk, TF_FULL, 64, (), TF_KV_BATCHES,
                                      (64 + 63, 100), jitter=0.0, bf16=True))
    stamp("K7, full width, bf16")
    err_full = merge_max(err_full, check_transformer(torch, mmk, td, tk, TF_LONG, 48, (1, 2),
                                                     (1, 16), (48 + 63, 20), jitter=0.0))
    stamp("K6 and K7 at rf 512")
    err_full.update(check_jukebox(torch, mmk, jbd, JB_FULL, JB_CHECK_BATCHES, 256,
                                  (256 + 15, 100), jitter=0.0))
    stamp("K8, full width")
    need = fl.WIDE_BLOCKS // fl.WIDE_CL
    fits = {(H, str(dt).split(".")[-1], bw): fl.wide_clusters_that_fit(H, bw, dt)
            for H, dt in ((512, torch.float32), (1024, torch.float32), (768, torch.bfloat16),
                          (1024, torch.bfloat16)) for bw in (False, True)}
    log("  the wide kernels' clusters of %d blocks the card holds (%d needed): %s"
        % (fl.WIDE_CL, need, ", ".join(f"H={H} {d} {'walk' if bw else 'forward'} {n}"
                                       for (H, d, bw), n in fits.items())))
    if min(fits.values()) < need:
        raise AssertionError(f"the card holds fewer than {need} wide clusters: {fits}")
    err_full = merge_max(err_full, check_lstm(torch, fl, LSTM_WIDE_SHAPES + LSTM_WIDE_B_SHAPES))
    err_full = merge_max(err_full, check_lstm_bf16(torch, fl, LSTM_WIDE_BF16_SHAPES
                                                   + LSTM_WIDE_BF16_B_SHAPES,
                                                   BF16_LSTM_WIDE_SHARES))
    check_wide_repeatable(torch, fl)
    stamp("the wide LSTM kernels, f32 and bf16")
    err = merge_max(err, err_full)
    check_train_step(torch, mmk, fl)
    for H, param_dtype in WIDE_TRAIN:
        check_train_step(torch, mmk, fl, hidden_dim=H, bf16=bool(param_dtype))
    stamp("full train steps at H = 256, 512 and 768")

    # -- phase 3 -------------------------------------------------------------
    log(f"phase 3: the serving paths at full width (at {time.perf_counter() - t_start:.1f} s)")
    net = make_net(mmk, torch, FULL, seed=0)
    rf = net.rf
    p4, p256 = (make_prompt(torch, B, 2 * rf, FULL["q_levels"], seed=B) for B in (4, 256))
    sd.decode_single.launches = sd.decode_single.launches_cluster = 0
    sd.decode_chunk.launches = sd.decode_chunk.launches_cluster = 0
    outs = main_path(torch, mmk, net, p4, p256)
    prior_t = p256.shape[1]
    gap, parted = verify(torch, sd, net, p256, outs[256][:, prior_t : prior_t + N_WIDE_VERIFY],
                         SEED, TEMPERATURE)
    err["decode_chunk"] = max(err["decode_chunk"], gap)
    log(f"  generate B=256 output, its first {N_WIDE_VERIFY} steps verified: max gap {gap:.3e},"
        f" {parted} streams parted at near-ties")
    launches = {"decode_single": sd.decode_single.launches,
                "decode_chunk": sd.decode_chunk.launches}
    cluster_launches = {"decode_single": sd.decode_single.launches_cluster,
                        "decode_chunk": sd.decode_chunk.launches_cluster}
    log(f"  launches on the serving path: {launches}, of which the cluster kernel"
        f" {cluster_launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the serving path was never launched: {launches}")
    if cluster_launches != launches:
        raise AssertionError("generate at B=4 (decode_single) or B=256 (decode_chunk) did not"
                             " take the cluster kernel")
    stamp("SampleRNN-3, f32")
    samplernn_route_sweep(torch, sd, net)
    stamp("SampleRNN-3's route sweep")
    srnn16_launches, gap = samplernn_bf16_path(torch, mmk, sd, net, p4, p256)
    err["decode_chunk_bf16"] = max(err["decode_chunk_bf16"], gap)
    stamp("SampleRNN-3, bf16")
    wn_net, wn_prompts, wn_launches, gap = wavenet_path(torch, mmk, wd, cat)
    stamp("WaveNet-10")
    err["wavenet_decode_chunk"] = max(err["wavenet_decode_chunk"], gap)
    tf_net, tf_prompts, tf_launches, gap = transformer_path(torch, mmk, td, tk)
    err["transformer_decode_window"] = max(err["transformer_decode_window"], gap)
    stamp("transformer8l, f32")
    tf16_launches, gap = transformer_bf16_path(torch, mmk, td, tk, tf_net, tf_prompts)
    err["transformer_decode_chunk_bf16"] = max(err["transformer_decode_chunk_bf16"], gap)
    stamp("transformer8l, bf16")
    jb_net, jb_prompts, jb_launches, gaps = jukebox_path(torch, mmk, jbd)
    err = merge_max(err, gaps)
    jukebox_route_sweep(torch, jbd, jb_net, jbd.jukebox_weight_pack(jb_net))
    stamp("jukebox3")

    # -- phase 4 -------------------------------------------------------------
    log(f"phase 4: the training path at full width (at {time.perf_counter() - t_start:.1f} s)")
    train_launches = train_path(torch, mmk, fl, sd, mu)

    # -- phase 5 -------------------------------------------------------------
    log("phase 5: each wrapper, its plain twin and its yardstick at the main paths' shapes"
        f" (at {time.perf_counter() - t_start:.1f} s)")

    # each wrapper, and its plain twin (over SRN_PLAIN_STEPS steps, scaled), on one
    # call at the main path's shapes
    pack = sd.samplernn_weight_pack(net)
    n_twin = SRN_PLAIN_STEPS
    calls = {
        "decode_single": (p4, lambda: sd.decode_single(pack, p4, N_SMALL, SEED, TEMPERATURE),
                          lambda: sd.decode_plain(net, p4, sd.init_decode_state(net, p4), rf,
                                                  n_twin, p4.shape[1], n_twin, SEED,
                                                  TEMPERATURE),
                          rf, p4.shape[1] + N_SMALL - rf, N_SMALL),
        "decode_chunk": (p256, lambda: sd.decode_chunk(pack, p256, sd.init_decode_state(net, p256),
                                                       rf, net._CHUNK, SEED, TEMPERATURE),
                         lambda: sd.decode_plain(net, p256, sd.init_decode_state(net, p256), rf,
                                                 n_twin, rf, n_twin, SEED, TEMPERATURE),
                         rf, net._CHUNK, net._CHUNK),
    }
    sources = {"decode_single": k2_source(sd, pack, 4),
               "decode_chunk": k2_source(sd, pack, 256)}
    replaces = {"decode_single": "mimikit_tpu/ops/pallas_decode.py:148",
                "decode_chunk": "mimikit_tpu/ops/pallas_decode.py:868"}
    block = {"decode_single": lambda: sd.decode_single(pack, p4, N_SMALL, SEED, TEMPERATURE,
                                                       cl=0),
             "decode_chunk": lambda: sd.decode_chunk(pack, p256, sd.init_decode_state(net, p256),
                                                     rf, net._CHUNK, SEED, TEMPERATURE, cl=0)}
    rows = []
    for name, (prompt, kern, plain, t0, n, out_len) in calls.items():
        k_ms, _ = spread(cuda_ms(torch, kern, reps=3))
        p_ms = cuda_ms(torch, plain, reps=1)[0] * n / n_twin
        b_ms = block_kernel_ms(torch, block.get(name))
        bound, by = decode_bound(pack, prompt.shape[0], prompt.shape[1], t0, n, out_len)
        log(f"  {name} B={prompt.shape[0]} steps={n}: kernel {k_ms:.3f} ms (median of 3),"
            f" plain twin {p_ms:.3f} ms ({n_twin} steps timed, scaled by {n / n_twin:g}),"
            f" bound {bound:.3f} ms by {by}"
            + (f"; the block kernel {b_ms:.3f} ms" if b_ms is not None else ""))
        rows.append(dict(
            name=name, route="cuda", source=sources[name], replaces=replaces[name],
            launches=launches[name], max_abs_err=err[name], ms=k_ms, plain_ms=p_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            cluster_launches=cluster_launches[name],
            **({"block_kernel_ms": b_ms} if b_ms is not None else {}),
        ))
    lstm_fwd_sweep(torch, fl)
    lstm_bwd_sweep(torch, fl)
    # the LSTM rows at the wider tier shape, (T, B, H) = (256, 32, 256), f32 and bf16
    lstm = {**lstm_timings(torch, fl, torch.float32)[LSTM_SHAPES[-1][0]],
            **lstm_timings(torch, fl, torch.bfloat16)[LSTM_SHAPES[-1][0]]}
    # the wide kernels' rows at the wider tier shape of phase 4's wide runs
    for dtype, shape in ((torch.float32, LSTM_WIDE_ROWS["float32"]),
                         (torch.bfloat16, LSTM_WIDE_ROWS["bfloat16"])):
        lstm.update(lstm_timings(torch, fl, dtype, (shape,))[shape[0]])
    for name, line in (("lstm_forward", 111), ("lstm_backward", 197),
                       ("lstm_forward_bf16", 111), ("lstm_backward_bf16", 197),
                       ("lstm_forward_wide", 111), ("lstm_backward_wide", 197),
                       ("lstm_forward_wide_bf16", 111), ("lstm_backward_wide_bf16", 197)):
        rows.append(dict(
            name=name, route="cuda", source="mimikit_tpu_torch/csrc/fused_lstm.cu",
            replaces=f"mimikit_tpu/ops/pallas_lstm.py:{line}",
            launches=train_launches[name], max_abs_err=err[name], **lstm[name],
        ))
    rows += wavenet_rows(torch, wd, cat, wn_net, wn_prompts, wn_launches, err)
    rows += transformer_rows(torch, td, tk, tf_net, tf_prompts, tf_launches, err)
    rows += bf16_rows(torch, sd, td, tk, net, p4, p256, tf_net, tf_prompts,
                      {**srnn16_launches, **tf16_launches}, err)
    rows += jukebox_rows(torch, jbd, mu, jb_net, jb_prompts,
                         {**jb_launches, **{k: train_launches[k] for k in ("mulaw_compress",
                                                                            "mulaw_expand")}}, err)
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
