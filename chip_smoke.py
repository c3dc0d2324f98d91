#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hammlet_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero and prints no result):
1. card: nvidia-smi name and power limit, torch's device name;
2. build: nvcc builds csrc/maxlet.cu, csrc/fbscan.cu and
   csrc/modelupdate.cu for sm_90a into hammlet_tpu_torch/build/, all three
   started together (ptxas registers and spills of each kernel);
2b. states625 (first, in a process of its own: this script with
   STATES625_FLAG, while no engine of this process holds the card): four
   tracks of five levels, K = 625 = 5^4 (-s C 5 4; states625_steps: the 625
   means (a, b, c, d), a, b, c, d in {-6, -3, 0, 3, 6}, segments of 800,
   noise 1.0, seed 9) at T = 500,000 x 4 through device ingest (the maxlet
   kernels at dim 4): make_engine -> STATES625_SCHEME -> finalize, graphed
   and eager, same seed, phase_tracks' checks (every kernel launched, rows,
   every sweep a replay, the same bytes) but MAP agreement, which is
   reported: the burn-in's model must hold the five levels instead), peak
   memory and capacity per phase, two settled F phases; the sweep's own
   scan and model-update inputs checked and timed (its prefix is the tiled
   kernel with j streamed, whose transposes take a row of matrices in
   pieces above K = 512), and the prefix past 2^31 entries a call
   (STATES625_WIDE_B, on permutation matrices); then bin/hammlet-torch -s C 5 4 through cli.main
   with all seven streams (STATES625_CLI_RUNS): the default scheme's ops
   cut, under HAMMLET_MAX_CAPACITY = STATES625_CEILING (the streams'
   checks, the first M chunk truncated at the ceiling) and with none; F
   right after the prior draw with no ceiling (exit 1, one error naming the
   capacity, K and HAMMLET_MAX_CAPACITY, nothing recorded);
3. kernel: each Hopper maxlet kernel (chunk, cross-chunk) against its own
   plain torch version and the whole transform against
   wavelet.maxlet_transform, on the card and on the CPU, bit for bit, at
   KERNEL_SIZES x KERNEL_DIMS, and on the card at T = 64,000,000; both
   kernels against the golden model's transform (golden.reference.
   maxlet_transform) at T = 4,000,000, dim 1 and 3, bit for bit; NaN
   propagation; the CUDA kernels of one transform call (torch.profiler, in
   a child process: this script with PROFILE_FLAG); then one more line per
   TIMED_SHAPES entry: CUDA-event times (L2 flushed; warm, device only;
   warm with the host launch) of each kernel, the transform and their plain
   versions, beside the bound;
3b. fbscan: each FB scan kernel (csrc/fbscan.cu, through samplers/fb_cuda.py)
   against its plain version on the card at FB_SIZES x FB_KS x FB_ROWS (K >
   16 at FB_WIDE_SHAPES alone; the
   prefix within FB_RTOL / FB_ATOL, counting the cases that are bitwise; the
   suffix bitwise), each row of a 4-row call against a one-row call, a
   permuted and a transposed view, NaN propagation; after phase 9, the
   sweep's own cross-shard views (taken from the eager [sharded] engine)
   against the plain versions of their contiguous copies, then for each
   timed input both kernels checked against their plain versions on it,
   the CUDA kernels one call of each launches (the kernel nodes of the
   call captured into a CUDA graph, scan_kernels; one at the FB_ONE_LAUNCH
   inputs, the main path's shapes) and CUDA-event times of
   both (L2 flushed; warm, device only) and of their plain versions, beside
   the bound: the sweep's own matrices and maps at P = 1 and P = 4 (taken
   from the eager [graph] and [sharded] engines) and the K = 9 and K = 27
   sweeps' (from the eager [states9] and [states27] engines), uniform
   inputs at the same shapes, at the T = 250M per-shard shape, at a flat
   FB_FLAT and at K = 9, 10, 16, 17, 27, 32, 33, 36, 48, 64, 81 and 128,
   and the [states64] and [states81] sweeps' own; every K = 17-32 prefix
   call is the three wide kernels (FB_WIDE) and its suffix call one
   kernel, every K = 33-64 prefix call one tiled-product kernel (FB_DEEP),
   every K > 64 prefix call one tiled kernel with j streamed (FB_TILED) and
   its grouped suffix call three kernels (FB_SUFFIX_GROUPED; above K = 454
   the rows scan alone), and the library holds none of the deleted generic
   kernels (FB_GENERIC); above K = 512 (FB_HUGE_CASES, FB_HUGE_SPECIAL: K =
   513, 625, 729, 1024, flat and grouped, in one and four rows, with zeros,
   -0, subnormals, an infinity and NaN; the cross-shard calls at K = 625)
   bitwise, one tiled kernel per prefix call, and timed at FB_HUGE_TIMED;
   then the sweep's own and the uniform times side by side, and K = 10,
   27, 33-64 and 81-128 against the generic kernels' times
   (FB_GENERIC_K10_MS, FB_GENERIC_K27_MS, FB_GENERIC_DEEP_MS,
   FB_GENERIC_OVER64_MS);
3c. model: the sweep statistics kernel (csrc/modelupdate.cu, through
   models/model_cuda.py) bitwise against its plain version on the card at
   MODEL_ROWS x MODEL_KS x MODEL_DIMS (a masked tail and an overflowing
   count at B = 29,696), each row of a 4-row call against its one-row call;
   the resample kernel bitwise against its plain version over MODEL_DRAWS
   draws at each K, Gamma shapes 0.5-1e7; NaN statistics; after phase 9,
   for each timed input both kernels checked against their plain versions
   on it, the CUDA kernels one call of each launches (scan_kernels;
   exactly one each, as at every checked shape) and CUDA-event times (L2
   flushed; warm, device only)
   of both and of their plain versions, beside the bound and, on the P = 1
   sweep's own inputs, the times of the two-launch statistics and the
   one-thread-per-shape resample they replaced (MODEL_BEFORE_MS): the
   sweep's
   own statistics inputs, statistics and noise at P = 1 and P = 4 (taken
   from the eager [graph] and [sharded] engines), uniform inputs at T = 4M's
   burn-in capacity, at T = 250M's per-shard capacity in four rows and at
   K = 10, dim 3, and the [states9], [states27], [states64] and [states81]
   sweeps' own (K = 9 dim 2, K = 27 dim 3, K = 64 dim 3, K = 81 dim 4);
   above K = 64 (MODEL_LARGE_K, MODEL_HUGE_K, MODEL_RESAMPLE_KS) both
   kernels bitwise, at (K, dim, B) = (81, 4, 4M) against the plain version's
   sums taken in chunks (stats_reference_in_chunks), one kernel per call;
   the statistics at (K, dim) = (625, 4), (729, 6), (512, 9) and (1024, 10)
   and the resample at K = 625 and 1024, timed at (625, 4) and (1024, 10);
4. main path: make_engine -> run_scheme("M 64 0 F 512 4") -> finalize at
   T = 4,000,000 positions, 3 states (the repo benchmark's configuration),
   checking that ingest launched both kernels, that every marginal row
   sums to the 128 recorded sweeps, that the MAP state agrees with the
   true segmentation on >= 95% of positions, and that every sweep was a
   replay of a captured CUDA graph (samplers/phase_graph.py); then the FB
   sampler's
   per-block state frequencies on the card against
   golden.reference.fb_gibbs_sweep on a small model, FB_DRAWS draws each,
   within the Monte-Carlo bound of tests/test_torch_samplers.py;
5. settled: on phase 4's engine after its run, F 1536 4 (at least three
   chunks at the settled capacity) with marginals + parameters +
   compression (m), with every stream and the record drain on its worker
   thread (a), and with every stream and the drain made inline on the
   launching thread (i), three times each in the order m a i a i m i m a
   after a warm-up, giving settled sweeps/s, the drain's ms per chunk on the
   worker and the ms the launching thread waited for it;
5b. graph: phase 4's configuration through a graphed engine and through an
   engine whose chunks run the eager gibbs_phase (the plain version of the
   graphs), same seed: the same bytes (marginals, parameters, compression),
   graph captures and capture seconds per phase, peak device memory of
   each; then settled F 1536 4 on both in GRAPH_PAIRS alternating pairs
   (N under --turns N), medians and quartile distances; then T =
   64,000,000 on the one card, M 16 0 F 32 4 with graphs: setup, sweeps/s,
   peak memory, marginal rows and MAP agreement;
6. cli: the same data as a text file through hammlet_tpu_torch.cli.main with
   all seven outputs (-i M 64 0 F 512 4), checking the engine ran on the
   card through both kernels and every stream's structure (one line per
   recorded sweep; blocks and sequences cover T; compression is T/#blocks;
   sequence boundaries lie on marginals boundaries; each segments line
   counts the union of the boundaries recorded so far; rows sum to 128;
   MAP agreement); prints the all-streams F-phase rate and its ratio to
   phase 4's;
7. resume: at T = 200,000, M 32 0 -> save_checkpoint -> new engine ->
   restore_checkpoint -> F 64 4 must equal the uninterrupted run bit for bit
   (marginal counts and emission means), and equal to the run whose chunks
   run the eager gibbs_phase; both graphed engines replayed graphs;
8. debug: with HAMMLET_DEBUG=1 a healthy F chunk reports error bits 0 and a
   NaN emission mean raises FloatingPointError;
9. sharded: phase 4's data through the position-sharded engine with P = 4
   shards on the one card (make_sharded_engine -> M 64 0 F 512 4 ->
   finalize), checking (a) that the sharded host ingest's per-position
   breakpoint weights equal ingest_device's (which launches the maxlet
   kernels) bit for bit, (b) that under one fixed model one sweep's block
   partition equals the single-device engine's, (c) marginal rows sum to
   128 and MAP agreement >= 0.95, (d) that a sharded F chunk runs under
   torch.cuda.set_sync_debug_mode("error") (the plain version; the graphed
   engine's chunks are held to the same in tests/test_torch_cuda.py), (e)
   that the same run inside a world-size-1 NCCL process group, where every
   collective goes through NCCL between the replays of the sweep's segment
   graphs, writes the same bytes as without one, (f) that a P = 4
   checkpoint resume at T = 200,000 into a graphed engine is bitwise equal
   to the uninterrupted run, (g) that bin/hammlet-torch -D 4 with one card
   visible stays in one process (and NVML counts the cards torch counts),
   and (h) that the engine whose chunks run the eager sharded_phase (the
   plain version of the graphs) writes the graphed engine's bytes; prints
   setup and host ingest seconds, the first F-phase rate next to phase 4's,
   captures, the settled rates of P = 1 (phase 4's engine) first and last
   and of P = 4 graphed and eager in SHARDED_PAIRS alternating pairs, and
   peak memory;
9b. states9: configuration 4 of benchmarks/run_configs.py (two tracks, 3
   emission parameters per track, K = 9 states, -s C 3 2; config4_steps)
   at T = 4,000,000 positions x 2 through device ingest: make_engine ->
   SCHEME -> finalize with graphs and through the eager gibbs_phase, same
   seed, checking that ingest launched both maxlet kernels and the sweep
   every kernel, that every marginal row sums to the 128 recorded sweeps,
   MAP agreement >= 0.95, every sweep a graph replay, and the same bytes;
   settled F rates (median of TRACKS_SETTLED and the spread), settled
   capacity, peak memory (of setup and of each phase, with the capacity it
   ended at), the maxlet kernels at dim 2 on this data; the
   configuration at its own T (400,000 x 2, host ingest) through
   bin/hammlet-torch -s C 3 2 -a in a subprocess (rows, MAP agreement);
   [profile] adds its graphed sweep (FB scan kernels must be the team
   instances) and its eager sweep's device ms by stage;
9c. states27: the same for three tracks, K = 27 = 3^3 states (-s C 3 3;
   states27_steps: the 27 means (a, b, c), a, b, c in {-3, 0, 3}, segments
   of 800, noise 1.0, seed 6) at T = 4,000,000 x 3 (the maxlet kernels at
   dim 3), and at T = 400,000 x 3 through bin/hammlet-torch -s C 3 3 -a;
   its FB prefix runs the wide instances (a thread block cluster per
   group), which [profile] requires in its graphed sweep; [fbscan] and
   [model] check and time the kernels on its sweep's own inputs (K = 27,
   dim 3), and the kernels line lists its two scans;
9d. states64: the same for three tracks of four levels, K = 64 (-s C 4
   3; states64_steps, seed 7), settled phases of STATES64_SETTLED_ITERS;
   its prefix is the tiled product (one launch);
9e. states81: the same for four tracks of three levels, K = 81 = 3^4
   (-s C 3 4; states81_steps: the 81 means (a, b, c, d), a, b, c, d in
   {-3, 0, 3}, segments of 800, noise 1.0, seed 8) at T = 4,000,000 x 4
   (the maxlet kernels at dim 4) and at T = 400,000 x 4 through
   bin/hammlet-torch -s C 3 4 -a, settled phases of STATES81_SETTLED_ITERS;
   its prefix is the tiled product with j streamed (one launch), its
   suffix the grouped form (three), its M burn-in's statistics at B = 4M
   the kernel with the pair terms in slices; [profile] requires them in
   its graphed sweep;
9f. sharded_tracks: the data of 9b-9e (T = 4,000,000 per track, K = 9, 27,
   64, 81) through the position-sharded engine with P = 4 shards on the
   one card (make_sharded_engine -> SCHEME, at K = 64 and 81
   SHARDED_TRACKS_CUT_SCHEME -> finalize), graphed and through the eager
   sharded_phase, checking (a) the sharded ingest's weights against
   ingest_device's at the data's dim, bit for bit, (b) the same bytes, (c)
   marginal rows that cover T and count the recorded sweeps, (d) MAP
   agreement >= 0.95, (e) every sweep a graph replay, no plain version
   called (PlainCalls), every sweep kernel launched; settled rates beside
   the same run's P = 1 rate of the same data, peak memory per phase;
   [fbscan] and [model] check and time the kernels on each sharded
   sweep's own inputs (four rows, and the cross-shard views), and (f)
   [profile] requires each hand-written kernel in the graphed P = 4 sweep
   as often as the sweep's own calls launch it, and no generic kernel;
   [fbscan] also checks the cross-shard calls at P = 2-4 for K = 9-81
   (FB_CROSS_CASES) and [model] the statistics at the sharded M burn-in's
   four rows of 1,048,576 blocks (MODEL_SHARDED_ROWS);
9g. cli_tracks: the CLI's user surface (cli.main on the card, engine seed
   CLI_TRACKS_SEED) on the data of 9b-9e at CLI_TRACKS_T = 400,000
   positions per track: (a) CLI_TRACKS_SCHEME, the default scheme's ops in
   order with its sweeps cut, and all seven streams at K = 9, 27, 64 and
   81, the streams checked at K columns (check_streams: [cli]'s checks,
   MAP agreement among them), graphed against eager at CLI_TRACKS_EAGER;
   (b) the same with -C CLI_TRACKS_CKPT_EVERY in a child killed right
   after its first checkpoint, then resumed: (a)'s bytes, the checkpoint's
   size and write seconds, at CLI_TRACKS_RESUME; (c) -M over two inputs of
   CLI_TRACKS_CHAIN_T x 3 tracks (device ingest; the maxlet kernels first
   checked on them), two threads on cuda:0 against one after another: the
   same bytes, the peak memory; (d) phase 8 at K = 81; (e) F phases right
   after a prior draw (CLI_TRACKS_PRIOR_RUNS): the first chunk's capacity,
   seconds and peak, K = 64 and 81 under CLI_TRACKS_CEILING truncated with
   an exact recording, K = 81 with no ceiling (it runs, or exits 1 with
   one error naming the capacity, K and HAMMLET_MAX_CAPACITY and no output
   written as if finished); (f) no
   plain version ran (PlainCalls) and every kernel launched; then the
   scans and the model update of one eager F sweep right after a prior
   draw at each (e) capacity against their plain versions, timed into the
   kernels line;
10. chains: two chromosomes of T = 2,500,000 positions (100-bp bins) as
   text files; first each maxlet kernel against its plain version on each
   chromosome's data as the CLI reads it, bit for bit, on the card and on
   the CPU; then through cli.main -M, the threaded path (cli._chain_devices
   giving cuda:0 twice: two threads, taking turns at phases) and the
   threaded path without turns ("free") against the sequential one (one
   device), in the order of CHAIN_ORDER, checking byte-identical
   marginals/parameters/compression, two threads, one launch of each
   maxlet kernel per chain, and graph replays in every chain's engine;
11. tools: bin/hammlet-torch-max-segmentation and -sort-states on chain
   1's outputs in subprocesses (this machine has no JAX);
12. profile: torch.profiler over F 64 4 on phase 4's engine with
   HAMMLET_DEBUG off and on (the invariant bitmask must add kernels when on)
   and on phase 9's, giving CUDA kernels and device ms per sweep; per
   settled sweep of the graphed engine and of the eager one, and of phase
   9's graphed and eager engines, the CUDA
   runtime's launch calls (cudaLaunchKernel, cudaGraphLaunch), device
   kernels, device ms and busy share, and the ten costliest kernels inside
   the graphed sweep, and every FB scan kernel in the graphed P = 1 and
   P = 4 sweeps (both must be there), and both model-update kernels there
   too; the eager sweep's device ms by the stage of the sweep that launched
   each kernel, and the kernels of the model update's two stages (only its
   kernels and the resample's draws); last, because a process that has
   run the profiler launches more slowly;
then the kernels JSON line, the nvidia-smi line, and the result line.

``python3 chip_smoke.py --sharded-cards N [PAIRS [T]]`` runs phase [cards]
alone; it needs N cards: (a) on each card both maxlet kernels bitwise
against their plain versions and the golden transform (T = 4,000,000, dim 1
and 3), and both FB scan and both model-update kernels bitwise against
their plain versions; (b) the main path's data and scheme through bin/hammlet-torch -f
-D N with -C, which spawns N processes, one per card, over NCCL, against
the same command under CUDA_VISIBLE_DEVICES=0 (one process, N shards on one
card), byte for byte, and a third N-process run killed after its first
checkpoint and resumed, byte for byte (every engine graphed); (c) in one
N-process group, W = N (one shard per card) graphed (segment graphs, the
collectives eager between them) against W = N with its chunks through the
eager sharded_phase, byte for byte, then settled F 512 4 rates in PAIRS
rotations of the two, P = 1 and P = N on card 0, then torch.profiler on
rank 0 over F 64 4 of W = N graphed and eager: launch calls, CUDA kernels,
NCCL kernels and NCCL device ms per sweep, and host ms in the collective
calls; (d) T positions (250,000,000 by
default: chr1 at 1 bp) made by a data provider in each process, -D N over N
cards, M 16 0 F 32 4: setup seconds, M and F sweeps/s, each card's peak
memory, marginal rows that cover T and count the 8 recorded sweeps, MAP
agreement >= 0.95; (g) (b) and (c) again on three tracks at K = 27
(states27_steps, T = 4,000,000 per track, -s C 3 3). In (c) and (g) every
rank must have captured the same graphs.

``python3 chip_smoke.py --chains-cards N [PAIRS]`` runs phase 10 alone on N
cards (one chain per card in threads, against the N chains one after
another on cuda:0, in PAIRS pairs, 2 by default) and prints its line; it
needs N cards. ``python3 chip_smoke.py --turns N`` runs phases 4, 5 and 10
on one card with N pairs of each comparison (the side that runs first
alternating), and N pairs of [graph]'s graphed against eager settled
phases, and prints the pairs each side won, medians and quartile
distances.

Needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hammlet_tpu_torch import checkpoint, cli, native, runner
from hammlet_tpu_torch.device import synchronize
from hammlet_tpu_torch.golden import reference as golden
from hammlet_tpu_torch.io.input import read_values
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.models import hmm, model_cuda
from hammlet_tpu_torch.ops import wavelet, wavelet_cuda
from hammlet_tpu_torch.parallel import distributed, launch, sharded
from hammlet_tpu_torch.parallel.ingest import sharded_ingest
from hammlet_tpu_torch.parallel.mesh import PositionMesh, position_mesh
from hammlet_tpu_torch.samplers import fb_cuda, sweep
from hammlet_tpu_torch.samplers import forward_backward as fb
from hammlet_tpu_torch.samplers.forward_backward import fb_sample_states

T_MAIN = 4_000_000
T_RESUME = 200_000
SCHEME = "M 64 0 F 512 4"
N_RECORDED = 128  # F 512 sweeps at thinning 4
SETTLED_ITERS = 1536  # [settled]: three 512-sweep chunks at the settled capacity
SETTLED_ORDER = ("mpc", "all", "inline", "all", "inline", "mpc", "inline", "mpc", "all")
T_CHAIN = 2_500_000  # [chains]: a chromosome at 100-bp bins, so device ingest runs
CHAIN_SCHEME = "M 32 0 F 256 4"
CHAIN_RECORDED = 64
CHAIN_ORDER = ("sequential", "threads", "free", "free", "threads", "sequential")  # [chains]
GRAPH_PAIRS = 3  # [graph]: settled pairs of graphed and eager phases (--turns N: N)
T_ONE_CARD = 64_000_000  # [graph]: the largest single-card run of this script
ONE_CARD_SCHEME = "M 16 0 F 32 4"
ONE_CARD_RECORDED = 8
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")
SEGLEN = 500
SEED = 0
MAP_AGREEMENT_MIN = 0.95
P_SHARDED = 4  # shards of the [sharded] phase, all on the one card
SHARDED_PAIRS = 3  # [sharded]: settled pairs of graphed and eager P = 4 phases
KERNEL_SIZES = [100, 8192, 8193, 100_000, 4_000_000]
KERNEL_DIMS = [1, 3]
T_LARGE = 64_000_000  # whole transform checked on the card only
TIMED_SHAPES = [(T_MAIN, 1), (T_MAIN, 3), (T_LARGE, 1)]
TIMING_REPS = 20
FLUSH_BYTES = 256 << 20  # written between timed repetitions: > the 50 MB L2
SLEEP_CYCLES = 10_000_000  # ~5 ms of device sleep while the host queues a timed call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PROFILE_FLAG = "--profile-transform"
CHAINS_FLAG = "--chains-cards"  # N [PAIRS]: [chains] alone, one chain per card on N cards
TURNS_FLAG = "--turns"  # N: N pairs of [settled]'s drain modes and of [chains]' -M paths
CARDS_FLAG = "--sharded-cards"  # N [PAIRS [T]]: [cards] alone, -D N over N cards
CARDS_PAIRS = 2  # [cards] (c): rotations of W = N, P = 1 and P = N
CARDS_CKPT_EVERY = 64  # [cards] (b): -C interval; the first checkpoint ends the M phase
T_BIG = 250_000_000  # [cards] (d): chr1 at 1 bp
BIG_SCHEME = "M 16 0 F 32 4"
BIG_RECORDED = 8
NOISE_BLOCK = 1 << 20  # [cards] (d): positions per separately seeded noise block
GROUP_VARS = ("HAMMLET_NUM_PROCESSES", "HAMMLET_COORDINATOR", "HAMMLET_PROCESS_ID",
              "HAMMLET_LOCAL_DEVICES", "CUDA_VISIBLE_DEVICES")
FB_DRAWS = 3000  # [main]: draws of the FB sampler and of the golden one
COUNTED = (wavelet_cuda.maxlet_transform_cuda, wavelet_cuda.maxlet_chunks_cuda,
           wavelet_cuda.maxlet_cross_cuda, fb_cuda.prefix_matmul_scan_cuda,
           fb_cuda.suffix_compose_scan_cuda, model_cuda.sweep_stats_cuda,
           model_cuda.resample_model_cuda)
COUNT_NAMES = ("transforms", "maxlet_chunk_kernel", "maxlet_cross_kernel",
               "prefix_matmul_scan_kernel", "suffix_compose_scan_kernel", "sweep_stats_kernels",
               "resample_model_kernel")
MAXLET_NAMES = COUNT_NAMES[:3]  # launched once per ingest
SWEEP_NAMES = COUNT_NAMES[3:]  # launched by every eager sweep and every capture
KERNEL_ROWS = (  # name (the kernels a call runs on the main path), source, the TPU code it
    # replaces, key in the timing results, key in COUNT_NAMES
    ("maxlet_chunk_kernel", "hammlet_tpu_torch/csrc/maxlet.cu",
     "hammlet_tpu/ops/wavelet_pallas.py:41", "chunk", "maxlet_chunk_kernel"),
    ("maxlet_cross_kernel", "hammlet_tpu_torch/csrc/maxlet.cu",
     "hammlet_tpu/ops/wavelet_pallas.py:130", "cross", "maxlet_cross_kernel"),
    ("fbscan_prefix_one_kernel", "hammlet_tpu_torch/csrc/fbscan.cu",
     "hammlet_tpu/samplers/forward_backward.py:94", "prefix", "prefix_matmul_scan_kernel"),
    ("fbscan_suffix_one_kernel", "hammlet_tpu_torch/csrc/fbscan.cu",
     "hammlet_tpu/samplers/forward_backward.py:154", "suffix", "suffix_compose_scan_kernel"),
    ("modelupdate_stats_kernel", "hammlet_tpu_torch/csrc/modelupdate.cu",
     "hammlet_tpu/samplers/sweep.py:100", "stats", "sweep_stats_kernels"),
    ("modelupdate_resample_kernel", "hammlet_tpu_torch/csrc/modelupdate.cu",
     "hammlet_tpu/models/hmm.py:128", "resample", "resample_model_kernel"),
)
FB_SIZES = [8, 130, 256, 384, 29_696, 433_920, 500_000]  # [fbscan]: block counts B
FB_BIG = 433_920  # [cards] (d)'s capacity per shard at T = 250M: 3,390 group totals
FB_ROWS = [1, 4]  # [fbscan]: batch rows R (the sharded engine's local shards)
# [fbscan]: states K (9-16: the team instances; 17-32: the wide ones; 33-64: the tiled products)
FB_KS = [1, 2, 3, 5, 9, 10, 12, 16, 17, 20, 21, 27, 32, 33, 36, 48, 64]
# [fbscan]: (B, R) checked at K > 16, where the plain versions of (K, K, 4, 500,000) do not fit
# the phase's time: FB_SIZES below 433,920 in both rows, 433,920 in one row
FB_WIDE_SHAPES = [(B, R) for B in FB_SIZES if B < 433_920 for R in FB_ROWS] + [(433_920, 1)]
# [fbscan]: (B, R) checked at K = 33-64 (K = 64 also at (433,920, 1))
FB_DEEP_SHAPES = [(B, R) for B in FB_SIZES if B <= 29_696 for R in FB_ROWS]
# [fbscan]: (K, B, R) checked above K = 64 (the tiled products with j streamed; one tile a side
# up to K = 128, two above): K = 65-128 flat and grouped in both rows and at the P = 1 capacity,
# K = 129-243 flat and grouped in both rows (the plain versions' K^3 products bound the shapes)
FB_TILED_CASES = ([(K, B, R) for K in (65, 81, 96, 128) for B in (8, 130, 256, 384)
                   for R in FB_ROWS] + [(81, 29_696, 1), (128, 29_696, 1)]
                  + [(K, B, R) for K in (129, 160, 243) for B in (8, 130, 384) for R in FB_ROWS])
# [fbscan]: (K, B, R) checked above K = 512 (the tiled kernel's transposes take a row of matrices
# in pieces): -s C 2 9's 513 - 1, -s C 5 4's 625, -s C 3 6's 729, -s C 2 10's 1024, flat and in
# one row grouped (at K = 1024 the timed input, FB_HUGE_TIMED); the plain versions' K^3 combines
# take ~21 s at K = 1024, B = 384
FB_HUGE_KS = [513, 625, 729, 1024]
FB_HUGE_CASES = ([(K, B, R) for K in FB_HUGE_KS for B, R in ((4, 1), (4, 4), (130, 1))]
                 + [(K, 384, 1) for K in FB_HUGE_KS[:-1]] + [(625, 130, 4)])
# [fbscan]: (B, K) of the K > 512 calls with zeros, -0 and subnormals, an infinity and NaN
FB_HUGE_SPECIAL = [(130, 513), (130, 625), (4, 729), (4, 1024)]
# [fbscan]: the timed K > 512 inputs, K -> B (one row, grouped), with the plain version once
FB_HUGE_TIMED = {625: 384, 1024: 384}
FB_RTOL, FB_ATOL = 1e-6, 1e-30  # [fbscan]: prefix kernel against its plain version
FB_FLAT = 500_000  # [fbscan]: a flat B (not a multiple of 128) too long for one CTA
# [fbscan] timed inputs whose scan calls must each be one CUDA kernel (the main path's shapes,
# and K = 9 and 10 at its P = 1 capacity: the one-launch team instances)
FB_ONE_LAUNCH = ("P=1 sweep data", f"P={P_SHARDED} sweep data", "P=1 uniform",
                 f"P={P_SHARDED} uniform", "K=9 uniform", "K=10 uniform")
# the generic prefix kernels, deleted (mangled): the built library must hold none of them
FB_GENERIC = ("fbscan_prefix_group_any_kernel", "fbscan_prefix_combine_any_kernel",
              "fbscan_prefix_rows_grid_kernelILi0E")
# the same as torch.profiler names them (demangled)
FB_GENERIC_LABELS = ("fbscan_prefix_group_any_kernel", "fbscan_prefix_combine_any_kernel",
                     "fbscan_prefix_rows_grid_kernel<0>")
# the wide prefix instances (K = 17-32): group, totals and combine kernels, three per call
FB_WIDE = ("fbscan_prefix_wide_group_kernel", "fbscan_prefix_team_rows_kernel",
           "fbscan_prefix_team_combine_kernel")
# the tiled-product prefix instance (K = 33-64): one cooperative launch per call
FB_DEEP = ("fbscan_prefix_deep_kernel",)
# the tiled-product prefix instance with j streamed (K > 64): one cooperative launch per call
FB_TILED = ("fbscan_prefix_tiled_kernel",)
# the grouped suffix above K = 64: group (maps in shared memory), totals' rows scan (one CTA per
# row, or over the card), combine; above FB_SUFFIX_FLAT_K the rows scan alone
FB_SUFFIX_GROUPED = ("fbscan_suffix_group_smem_kernel", "fbscan_suffix_rows_",
                     "fbscan_suffix_combine_kernel")
FB_SUFFIX_FLAT_K = 454  # a group's maps as int16 no longer fit a CTA's shared memory twice
# the FB scans at K = 27, B = 29,696, on the generic kernels the wide instances replaced (three
# launches each), ms with L2 flushed (NVIDIA H100 80GB HBM3, 700.00 W)
FB_GENERIC_K27_MS = {"prefix": 49.1638, "suffix": 0.0843}
# the FB scans at K = 33-64, B = 29,696, on the generic kernels the tiled products replaced, ms
# with L2 flushed, the mean of two turns of fbscan_probes.py deep (NVIDIA H100 80GB HBM3, 700.00 W)
FB_GENERIC_DEEP_MS = {33: {"prefix": 81.0150, "suffix": 0.0942},
                      36: {"prefix": 122.9840, "suffix": 0.1000},
                      48: {"prefix": 283.0770, "suffix": 0.1271},
                      64: {"prefix": 631.9546, "suffix": 0.3632}}
# the FB scans at K = 81 and 128, B = 29,696, on the generic kernels the tiled products with j
# streamed replaced (the suffix: the rows scan over the card), ms with L2 flushed, the mean of two
# turns of fbscan_probes.py over64 (NVIDIA H100 80GB HBM3, 700.00 W)
FB_GENERIC_OVER64_MS = {81: {"prefix": 1149.2838, "suffix": 0.5603},
                        128: {"prefix": 4671.3588, "suffix": 1.3857}}
# the FB scans at K = 10, B = 29,696, on the generic kernels they replaced (three launches each),
# ms with L2 flushed (NVIDIA H100 80GB HBM3, 700.00 W)
FB_GENERIC_K10_MS = {"prefix": 1.2159, "suffix": 0.0241}
# the three-launch prefix kernels (group, totals, combine; __fdiv_rn) on the P = 1 sweep's
# matrices, ms with L2 flushed (NVIDIA H100 80GB HBM3, 700.00 W)
FB_THREE_LAUNCH_PREFIX_MS = 0.0745
# the model-update kernels these replaced, on the P = 1 sweep's own inputs, ms with L2 flushed
# (the statistics in two launches, tile sums then row totals; the resample with one thread per
# Gamma shape; NVIDIA H100 80GB HBM3, 700.00 W)
MODEL_BEFORE_MS = {"stats": 0.0178, "resample": 0.0151}
# [model]: (R, B) rows of the statistics kernel's checks: the settled P = 1 capacity, T = 250M's
# per-shard capacity in four rows, T = 4M's M burn-in capacity, a short row
MODEL_ROWS = [(1, 30), (1, 29_696), (4, 433_920), (1, 4_000_000)]
MODEL_KS = [3, 10]  # [model]: states K
MODEL_DIMS = [1, 3]  # [model]: data dimensions (P = K at dim 1, 2 above)
MODEL_DRAWS = 50  # [model]: resample draws checked per K
MODEL_K64_ROWS = [(1, 29_696), (1, 262_144)]  # [model]: (R, B) checked at K = 64, dim 3
# [model]: (R, B, K, dim, P) checked above K = 64: -s C 3 4 (K = 81, dim 4) at the M burn-in's
# capacity at T = 4M (the plain version's leaves would take 108 GB: stats_reference_in_chunks)
# and at 262,144; -s C 2 7 (K = 128, dim 7) and -s C 3 5 (K = 243, dim 5) at the P = 1 capacity
MODEL_LARGE_K = [(1, 4_000_000, 81, 4, 3), (1, 262_144, 81, 4, 3), (1, 29_696, 128, 7, 2),
                 (1, 29_696, 243, 5, 3)]
# [model]: (R, B, K, dim, P) of the sharded M burn-in at T = 4M, P = 4 shards: four rows of
# T_local = 1,048,576 blocks, -s C 4 3 (K = 64, dim 3) and -s C 3 4 (K = 81, dim 4), against
# the plain version's sums in chunks
MODEL_SHARDED_ROWS = [(4, 1_048_576, 64, 3, 4), (4, 1_048_576, 81, 4, 3)]
# [model]: (R, B, K, dim, P) checked above K = 512 (the plain version's leaves take K^2 B floats):
# -s C 5 4 (K = 625, dim 4), -s C 3 6 (729, dim 6), -s C 2 9 (512, dim 9) and -s C 2 10 (1024,
# dim 10); above dim 8 the block statistics are read unstaged
MODEL_HUGE_K = [(1, 4096, 625, 4, 5), (1, 2048, 729, 6, 3), (1, 4096, 512, 9, 2),
                (1, 1024, 1024, 10, 2), (2, 512, 1024, 10, 2)]
# [model]: the resample above K = 64 (243 and up: in passes of rows; 1024: 1,049,600 shapes)
MODEL_RESAMPLE_KS = [128, 243, 625, 1024]
# [states9]: configuration 4 of benchmarks/run_configs.py (:160-172), "multi-track multivariate
# emissions: 2 tracks x 3 params = 9 states" (-s C 3 2): its means (:165-167), segments, noise, seed
CONFIG4_MEANS = ((0.0, 0.0), (0.0, 3.0), (3.0, 0.0), (3.0, 3.0), (-3.0, 0.0), (0.0, -3.0),
                 (-3.0, -3.0), (3.0, -3.0), (-3.0, 3.0))
CONFIG4_SEGLEN, CONFIG4_NOISE, CONFIG4_SEED = 800, 1.0, 4
CONFIG4_T = 400_000  # the configuration's own T: bin/hammlet-torch -s C 3 2, host ingest
STATES9_K = 9
TRACKS_SETTLED = 3  # [states9], [states27], [states64], [states81]: settled F phases, graphed engine
# [states27]: three tracks, three emission parameters per track, K = 27 = 3^3 states (-s C 3 3):
# every mean (a, b, c) for a, b, c in {-3, 0, 3}, segments and noise as configuration 4's, seed 6
STATES27_MEANS = tuple((a, b, c) for a in (-3.0, 0.0, 3.0) for b in (-3.0, 0.0, 3.0)
                       for c in (-3.0, 0.0, 3.0))
STATES27_K, STATES27_SEED = 27, 6
STATES27_CLI_T = 400_000  # [states27] through bin/hammlet-torch -s C 3 3 (host ingest)
# [states64]: three tracks, four emission parameters per track, K = 64 = 4^3 states (-s C 4 3):
# every mean (a, b, c) for a, b, c in {-4.5, -1.5, 1.5, 4.5} ([states27]'s spacing of 3), segments
# and noise as configuration 4's, seed 7
STATES64_MEANS = tuple((a, b, c) for a in (-4.5, -1.5, 1.5, 4.5) for b in (-4.5, -1.5, 1.5, 4.5)
                       for c in (-4.5, -1.5, 1.5, 4.5))
STATES64_K, STATES64_SEED = 64, 7
STATES64_CLI_T = 400_000  # [states64] through bin/hammlet-torch -s C 4 3 (host ingest)
STATES64_SETTLED_ITERS = 128  # [states64]'s settled F phases (~13 ms a sweep: the smoke's time)
# [states81]: four tracks, three emission parameters per track, K = 81 = 3^4 states (-s C 3 4):
# every mean (a, b, c, d) for a, b, c, d in {-3, 0, 3} ([states27]'s levels on a fourth track),
# segments and noise as configuration 4's, seed 8
STATES81_MEANS = tuple((a, b, c, d) for a in (-3.0, 0.0, 3.0) for b in (-3.0, 0.0, 3.0)
                       for c in (-3.0, 0.0, 3.0) for d in (-3.0, 0.0, 3.0))
STATES81_K, STATES81_SEED = 81, 8
STATES81_CLI_T = 400_000  # [states81] through bin/hammlet-torch -s C 3 4 (host ingest)
STATES81_SETTLED_ITERS = 128  # [states81]'s settled F phases (~25 ms a sweep: the smoke's time)
# [states625]: four tracks, five emission parameters per track, K = 625 = 5^4 states (-s C 5 4):
# every mean (a, b, c, d) for a, b, c, d in {-6, -3, 0, 3, 6} ([states27]'s spacing of 3),
# segments and noise as configuration 4's, seed 9
STATES625_MEANS = tuple((a, b, c, d) for a in (-6.0, -3.0, 0.0, 3.0, 6.0)
                        for b in (-6.0, -3.0, 0.0, 3.0, 6.0) for c in (-6.0, -3.0, 0.0, 3.0, 6.0)
                        for d in (-6.0, -3.0, 0.0, 3.0, 6.0))
STATES625_K, STATES625_SEED = 625, 9
STATES625_STATES = ["C", "5", "4"]  # -s C 5 4
# [states625]'s engine seed: the first whose M burn-in found the five levels on the card. Two
# chains in three settle instead with two emission means on one level and one spanning two (20
# of 64 seeds found the five levels; the JAX package's burn-in 14 of 32 at T = 40,000 on the
# CPU; PERF.md §6, ROADMAP §3). The gate is on the burn-in's model (STATES625_LEVEL_TOL,
# STATES625_VAR_MAX), not on MAP agreement: the F sweeps that follow lose the levels in both
# packages (a visited state's a_ss of ~0.5 over a block of 800 scales every forward column
# below the 1e-38 floor of the predecessor draws, hammlet_tpu/samplers/forward_backward.py:
# 242; ROADMAP §3), so the MAP agreement of the recorded F sweeps is reported
STATES625_ENGINE_SEED = 12
# [states625]: the burn-in found the five levels when each lies within STATES625_LEVEL_TOL of an
# emission mean and every emission variance is below STATES625_VAR_MAX (the data's noise is 1.0)
STATES625_LEVEL_TOL, STATES625_VAR_MAX = 0.5, 1.5
# [states625] runs in a process of its own (this script with STATES625_FLAG): at ~6.6 MiB a
# block, its F sweeps need a card that the other phases' engines do not hold. T = 500,000 a
# track: 2,000,000 values, ingest_device's threshold (runner.py:840), so both maxlet kernels run
# at dim 4. Its sweeps cut for the smoke's time (~1 s each; PERF.md §4): the scheme's F phase to
# 32 sweeps, two settled F phases of STATES625_SETTLED_ITERS
STATES625_FLAG = "--states625"
STATES625_T = 500_000
STATES625_SCHEME = "M 64 0 F 32 4"
STATES625_SETTLED_ITERS = 8
# the sweep's own prefix matrices checked against the plain version on their first blocks
# (three groups; at the whole capacity the plain version's K^3 combines would take ~45 s)
STATES625_CHECK_B = 384
# [states625]: the prefix kernel on calls whose K^2 B entries pass 2^31 at K = 625 (64-bit
# offsets), flat and grouped, on permutation matrices (prefix_permutations): ~9.4 GB a tensor,
# where the plain version's K^3 combines would take ~75 s a call
STATES625_WIDE_B = (6001, 6016)
# [states625]'s CLI part, bin/hammlet-torch -s C 5 4 with all seven streams: (scheme, ceiling,
# the method of its first phase after a prior draw, the exit). The default scheme's ops cut (M 500
# 0 S P F 200 0 F 300 3 to M 16 0 S P F 8 0 F 16 4) start with M chunks at ~T blocks (the prior's
# threshold), which need no K^2 a block, and its F phases after S P keep the burn-in's static
# threshold: it runs under HAMMLET_MAX_CAPACITY = 4096 (its first M chunk truncated there) and
# without one. An F phase right after the prior draw runs at ~T blocks, ~6.4 MB each: with no
# ceiling it exits 1 with the one error naming the capacity, K and HAMMLET_MAX_CAPACITY
STATES625_CEILING = 4096
STATES625_CLI_RUNS = [("M 16 0 S P F 8 0 F 16 4", STATES625_CEILING, "M", 0),
                      ("M 16 0 S P F 8 0 F 16 4", None, "M", 0),
                      ("F 8 0 F 16 4", None, "F", 1)]
# [sharded_tracks]: the sharded engine, P_SHARDED shards on the one card, on the data of
# [states9], [states27], [states64] and [states81] (T_MAIN positions per track, their seeds and
# means). K = 9 and 27 run SCHEME; K = 64 and 81 the cut scheme (the burn-in kept, F cut from
# 512 to 128 sweeps) for the smoke's time. Settled phases of 512 sweeps at K = 9 and 27, 64 at
# K = 64 and 81.
SHARDED_TRACKS_CUT_SCHEME = "M 64 0 F 128 4"
SHARDED_TRACKS_SETTLED = {9: 512, 27: 512, 64: 64, 81: 64}
# [fbscan]: the sharded sweep's cross-shard scans, (K, K, P) and (K, P), at P = 2, 3, 4 shards
FB_CROSS_CASES = [(B, K) for K in (9, 27, 64, 81, 625) for B in (2, 3, 4)]
ALL_STREAMS = ("marginals", "sequences", "parameters", "blocks", "compression", "mapping",
               "segments")
PER_SWEEP_STREAMS = ("sequences", "parameters", "blocks", "compression", "segments")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def synth(T: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """bench.py's data recipe: segments of SEGLEN positions in one of three
    states with means {0, 2, -2}, unit Gaussian noise. Returns (data, true
    per-position state)."""
    rng = np.random.default_rng(seed)
    means = np.array([0.0, 2.0, -2.0])
    n_seg = max(1, T // SEGLEN)
    state = rng.integers(0, 3, size=n_seg)
    reps = np.full(n_seg, SEGLEN)
    reps[-1] = T - SEGLEN * (n_seg - 1)
    data = np.repeat(means[state], reps) + rng.normal(0, 1, size=T)
    return data.astype(np.float32), np.repeat(state, reps)


def track_steps(means, T: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """benchmarks/run_configs.py's _steps (:85-92): segments of
    CONFIG4_SEGLEN positions, each at one of ``means`` (a row per state, a
    column per track) in a random order, noise CONFIG4_NOISE; the same
    draws. Returns ((T, tracks) float32 data, true state per position)."""
    rng = np.random.default_rng(seed)
    means = np.asarray(means)
    n_seg = max(1, T // CONFIG4_SEGLEN)
    state = rng.integers(0, len(means), size=n_seg)
    reps = np.full(n_seg, CONFIG4_SEGLEN)
    reps[-1] = T - CONFIG4_SEGLEN * (n_seg - 1)
    mu = np.repeat(means[state], reps, axis=0)
    data = (mu + rng.normal(0, CONFIG4_NOISE, size=mu.shape)).astype(np.float32)
    return data, np.repeat(state, reps)


def config4_steps(T: int, seed: int = CONFIG4_SEED) -> tuple[np.ndarray, np.ndarray]:
    """Configuration 4's data (two tracks, its means, seed 4): track_steps
    with CONFIG4_MEANS."""
    return track_steps(CONFIG4_MEANS, T, seed)


def states27_steps(T: int, seed: int = STATES27_SEED) -> tuple[np.ndarray, np.ndarray]:
    """[states27]'s data (three tracks, -s C 3 3): track_steps with the 27
    means STATES27_MEANS, seed 6."""
    return track_steps(STATES27_MEANS, T, seed)


def states64_steps(T: int, seed: int = STATES64_SEED) -> tuple[np.ndarray, np.ndarray]:
    """[states64]'s data (three tracks, -s C 4 3): track_steps with the 64
    means STATES64_MEANS, seed 7."""
    return track_steps(STATES64_MEANS, T, seed)


def states81_steps(T: int, seed: int = STATES81_SEED) -> tuple[np.ndarray, np.ndarray]:
    """[states81]'s data (four tracks, -s C 3 4): track_steps with the 81
    means STATES81_MEANS, seed 8."""
    return track_steps(STATES81_MEANS, T, seed)


def states625_steps(T: int, seed: int = STATES625_SEED) -> tuple[np.ndarray, np.ndarray]:
    """[states625]'s data (four tracks of five levels, -s C 5 4): track_steps
    with the 625 means STATES625_MEANS, seed 9."""
    return track_steps(STATES625_MEANS, T, seed)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors of one type (float NaNs equal where
    both are NaN: their payloads are not part of the contract), on a's
    device (the card's for the scans' gigabyte outputs; the host took
    minutes)."""
    b = b.to(a.device)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if a.dtype != b.dtype or not torch.equal(nan_a, nan_b):
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(bits).masked_fill(nan_a, 0), b.view(bits).masked_fill(nan_b, 0))


def max_abs_err(a, b) -> float:
    """Largest |a - b| where both are finite, on a's device; inf where
    they are not finite at the same places."""
    b = b.to(a.device)
    finite_a, finite_b = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(finite_a, finite_b):
        return float("inf")
    return float((a - b).abs().masked_fill(~finite_a, 0).max()) if a.numel() else 0.0


def time_ms(fn, before=None, reps: int = TIMING_REPS) -> float:
    """Median milliseconds per call from CUDA events, after a warm-up.
    ``before`` queues device work ahead of each repetition, outside the
    timed window: writing FLUSH_BYTES leaves none of fn's inputs in the
    50 MB L2, and a sleep keeps them there; either keeps the card busy while
    the host queues fn, so the window holds device time only. Without it the
    inputs stay warm and a short call also times its host launch (how this
    script timed the transform before it had the other two)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def reset_counts() -> None:
    for f in COUNTED:
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in zip(COUNT_NAMES, COUNTED)}


def eager_engine(eng):
    """``eng`` (a runner.Engine) with every phase chunk run through the
    eager samplers.sweep.gibbs_phase, the plain version of the CUDA graphs
    the engine replays: same streams, same bytes. Returns ``eng``."""

    class EagerEngine(runner.Engine):
        def _run_chunk(self, counter, method, n, thinning, record, want_blocks, debug):
            cand_pos, cand_rank = self._candidates()
            self._new_model, _, self._prev, *out = sweep.gibbs_phase(
                self.seed, counter, self.model, self.priors, self.ing.ranked, cand_pos,
                cand_rank, self.ing.prefix, self.buffers,
                None if self._dynamic else self._static_threshold,
                method=method, nr_params=self.spec.nr_params, mapping=self._mapping,
                use_self_transitions=self.spec.use_self_transitions, n_iters=n,
                thinning=thinning, cell_bits=self.ing.cell_bits, record=record,
                want_blocks=want_blocks, debug=debug,
            )
            return out

        def _accept_chunk(self):
            self.model = self._new_model

        def _rewind_chunk(self):
            if self._prev is not None:
                self.buffers = self._prev

    eng.__class__ = EagerEngine
    return eng


def eager_sharded_engine(eng):
    """``eng`` (a parallel.sharded.ShardedEngine) with every phase chunk
    run through the eager sharded.sharded_phase, the plain version of the
    CUDA graphs the engine replays: same streams, same bytes; an overflow
    replay rebinds the snapshot the plain version took. Returns ``eng``."""

    class EagerShardedEngine(sharded.ShardedEngine):
        def _run_chunk(self, counter, method, n, thinning, record, want_blocks, debug):
            candpos, candrank = self._shard_candidates()
            self._new_model, _, self._prev, *out = sharded.sharded_phase(
                self.mesh, self.seed, counter, self.model, self.priors, self.negw, candpos,
                candrank, self.r_t, self.q2_hi, self.q2_lo, self.buffers,
                None if self._dynamic else self._static_threshold,
                method=method, T=self.T, T_local=self.T_local, cell_bits=self.cell_bits,
                mapping=self._mapping, nr_params=self.spec.nr_params,
                use_self_transitions=self.spec.use_self_transitions, n_iters=n,
                thinning=thinning, record=record, want_blocks=want_blocks, debug=debug,
            )
            return out

        def _accept_chunk(self):
            self.model = self._new_model

        def _rewind_chunk(self):
            if self._prev is not None:
                self.buffers = self._prev

    eng.__class__ = EagerShardedEngine
    return eng


def check_graphed(eng, where: str) -> None:
    """Every sweep ``eng`` ran in this process was a replay of a captured
    CUDA graph (an overflowed chunk replays its sweeps again)."""
    pg, swept = eng.phase_graphs, int(eng.total_sweeps)
    check(eng.device.type == "cuda" and pg.captures >= 1 and pg.replays >= swept >= 1,
          f"{where}: {swept} sweeps but {pg.captures} captures and {pg.replays} graph replays")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card: the bytes over the HBM rate or the float32
    operations over the float32 peak, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(b, o), "bytes" if b >= o else "operations"


def transform_work(T: int, dim: int) -> dict:
    """(bytes, float32 operations) each kernel and the whole transform
    need at (T, dim): every input read once, every output written once; a
    tree node costs a subtract, an abs, a multiply and an add per dim, and
    a position dim - 1 maxes."""
    n = -(-T // (1 << wavelet_cuda.CHUNK_BITS))
    pairs, m = 0, n
    while m >= 2:  # chunk starts whose wavelet the cross levels form
        pairs += m // 2
        m //= 2
    per_node = 4 * dim + dim - 1
    return {
        "chunk": (4 * T * dim + 4 * T + 4 * n * dim, per_node * (T - n)),
        "cross": (4 * n * dim + 4 * pairs, per_node * pairs),
        "transform": (4 * T * dim + 4 * T, per_node * T),
    }


def check_kernels(x, x_cpu, worst: dict) -> None:
    """Each kernel on the card's ``x`` against its own plain version and the
    whole transform against wavelet.maxlet_transform, bit for bit, on the
    card and on the CPU (``x_cpu``, None for the card alone); the largest
    absolute errors go into ``worst``. Not counted: callers reset the
    counters before the run they count."""
    T, dim = x.shape
    kc, kt = wavelet_cuda.maxlet_chunks_cuda(x)
    kx = wavelet_cuda.maxlet_cross_cuda(kc.clone(), kt)
    got = wavelet_cuda.maxlet_transform_cuda(x)
    check(got.shape == (T,) and got.dtype == torch.float32, f"shape T={T}")
    for inp in (x, x_cpu) if x_cpu is not None else (x,):
        where = f"{inp.device.type}, T={T} dim={dim}"
        rc, rt = wavelet_cuda.maxlet_chunks_reference(inp)
        check(bits_equal(kc, rc) and bits_equal(kt, rt), f"chunk kernel != plain ({where})")
        rx = wavelet_cuda.maxlet_cross_reference(kc.to(inp.device, copy=True), kt.to(inp.device))
        check(bits_equal(kx, rx), f"cross kernel != plain ({where})")
        plain = wavelet.maxlet_transform(inp)
        check(bits_equal(got, plain), f"transform != wavelet.maxlet_transform ({where})")
        worst["chunk"] = max(worst["chunk"], max_abs_err(kc, rc), max_abs_err(kt, rt))
        worst["cross"] = max(worst["cross"], max_abs_err(kx, rx))
        worst["transform"] = max(worst["transform"], max_abs_err(got, plain))


def check_golden(x: torch.Tensor, want: torch.Tensor, worst: dict) -> None:
    """Both kernels on the card's ``x`` against ``want``, the golden model's
    transform of the same data (golden.reference.maxlet_transform), bit for
    bit: the chunk kernel's coefficients off the chunk starts (the levels it
    forms), and after the cross-chunk kernel every coefficient. The largest
    absolute error goes into ``worst["golden"]``. Not counted."""
    kc, kt = wavelet_cuda.maxlet_chunks_cuda(x)
    kx = wavelet_cuda.maxlet_cross_cuda(kc.clone(), kt).cpu()
    kc = kc.cpu()
    off = torch.arange(len(want)) % (1 << wavelet_cuda.CHUNK_BITS) != 0
    where = f"{x.device}, T={x.shape[0]} dim={x.shape[1]}"
    check(bits_equal(kc[off], want[off]), f"chunk kernel != golden maxlet_transform ({where})")
    check(bits_equal(kx, want), f"chunk + cross kernels != golden maxlet_transform ({where})")
    worst["golden"] = max(worst.get("golden", 0.0), max_abs_err(kc[off], want[off]),
                          max_abs_err(kx, want))


def phase_kernel() -> dict:
    """Each kernel against its own plain version and the whole transform
    against wavelet.maxlet_transform, bitwise, on the card and on the CPU,
    and both kernels against the golden transform at T_MAIN; times with L2
    flushed and warm."""
    worst = {"chunk": 0.0, "cross": 0.0, "transform": 0.0, "golden": 0.0}
    for T in KERNEL_SIZES:
        for dim in KERNEL_DIMS:
            data = np.random.default_rng(T * 7 + dim).normal(1, 2, (T, dim)).astype(np.float32)
            x_cpu = torch.from_numpy(data)
            check_kernels(x_cpu.cuda(), x_cpu, worst)
            if T == T_MAIN:
                check_golden(x_cpu.cuda(), torch.from_numpy(golden.maxlet_transform(data)), worst)
    big = large_input(T_LARGE, 1)
    check_kernels(big, None, worst)  # on the card only
    del big
    # NaN input: the max over dims must propagate NaN like the plain version
    data = np.random.default_rng(5).normal(0, 1, (100_000, 3)).astype(np.float32)
    data[[17, 4096, 8191, 77_777], [0, 2, 1, 2]] = np.nan
    x = torch.from_numpy(data).cuda()
    check(
        bits_equal(wavelet_cuda.maxlet_transform_cuda(x), wavelet.maxlet_transform(x)),
        "NaN propagation",
    )
    torch.cuda.synchronize()

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    timed = {}
    for T, dim in TIMED_SHAPES:
        if (T, dim) == (T_MAIN, 1):  # the main path's data
            x = torch.from_numpy(synth(T_MAIN, SEED)[0][:, None]).cuda()
        else:
            x = large_input(T, dim)
        kc, kt = wavelet_cuda.maxlet_chunks_cuda(x)
        buf = kc.clone()  # the cross-chunk step rewrites the same positions every call
        fns = {
            "chunk": lambda: wavelet_cuda.maxlet_chunks_cuda(x),
            "cross": lambda: wavelet_cuda.maxlet_cross_cuda(buf, kt),
            "transform": lambda: wavelet_cuda.maxlet_transform_cuda(x),
            "chunk_plain": lambda: wavelet_cuda.maxlet_chunks_reference(x),
            "cross_plain": lambda: wavelet_cuda.maxlet_cross_reference(buf, kt),
            "transform_plain": lambda: wavelet.maxlet_transform(x),
        }
        row = {}
        for name, fn in fns.items():
            row[name] = time_ms(fn, flush.zero_)
            row[name + "_warm_device"] = time_ms(fn, lambda: torch.cuda._sleep(SLEEP_CYCLES))
            row[name + "_warm"] = time_ms(fn)
        for name, (nbytes, ops) in transform_work(T, dim).items():
            row[name + "_bound"], row[name + "_bound_by"] = bound_ms(nbytes, ops)
        if dim > 1:  # the same rows off 16-byte alignment take the scalar-load instance
            off = torch.empty(T * dim + 1, dtype=torch.float32, device="cuda")[1:].view(T, dim)
            off.copy_(x)
            row["chunk_scalar"] = time_ms(lambda: wavelet_cuda.maxlet_chunks_cuda(off), flush.zero_)
            del off
        timed[(T, dim)] = row
        del x, kc, kt, buf, fns
    del flush
    torch.cuda.empty_cache()
    n_kernels, names = transform_kernel_count()
    check(n_kernels == 2, f"one maxlet_transform_cuda call ran {n_kernels} CUDA kernels: {names}")
    return {"worst": worst, "timed": timed, "profiled": n_kernels}


def fb_inputs(B: int, K: int, R: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, K, R, B) float32 block matrices with entries in [0.05, 1) and
    (K, R, B) int64 maps into [0, K), made on the card from ``seed``, padded
    as the sweep pads them: with R > 1 the second half of row 1 and all of
    the last row are identity matrices and identity maps."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.rand((K, K, R, B), generator=gen, device="cuda").mul_(0.95).add_(0.05)
    maps = torch.randint(0, K, (K, R, B), generator=gen, device="cuda")
    if R > 1:
        eye = torch.eye(K, device="cuda")[:, :, None]
        ident = torch.arange(K, device="cuda")[:, None]
        M[:, :, 1, B // 2:] = eye
        M[:, :, R - 1] = eye
        maps[:, 1, B // 2:] = ident
        maps[:, R - 1] = ident
    return M, maps


class ScanInputs:
    """While entered, keeps a copy of the input of every FB scan kernel
    call (through fb_cuda._scan, which both wrappers call; strides kept, so
    the sharded engine's cross-shard views stay views), the last one of
    each kind, shape and stride: ``seen[kind]`` maps (shape, stride) to the
    tensor. Run an eager engine inside it to take the sweep's own matrices
    and maps."""

    def __init__(self):
        self.seen: dict = {"prefix": {}, "suffix": {}}
        self.real = fb_cuda._scan

    def __enter__(self):
        def keep(kind, x, lead, what):
            self.seen[kind][(tuple(x.shape), x.stride())] = x.clone()
            return self.real(kind, x, lead, what)

        fb_cuda._scan = keep
        return self

    def __exit__(self, *exc):
        fb_cuda._scan = self.real

    def main_and_others(self) -> tuple:
        """((M, maps) of the largest call of each kind, [(kind, x), ...] of
        every other call: the sharded engine's cross-shard scans, on the
        tensors the sweep passed, strides kept)."""
        main = [max(self.seen[k].values(), key=lambda x: x.numel()) for k in ("prefix", "suffix")]
        others = [(k, x) for k, m in zip(("prefix", "suffix"), main)
                  for x in self.seen[k].values() if x is not m]
        return tuple(main), others


def check_scans(M: torch.Tensor, maps: torch.Tensor, where: str, errors: dict | None = None,
                want: torch.Tensor | None = None) -> bool:
    """Each FB scan kernel against its plain version on the contiguous copy
    of its input (``want``: the plain prefix's result, if taken already):
    the prefix within FB_RTOL / FB_ATOL (NaN where the plain version has
    NaN), the suffix bitwise. Returns whether the prefix was bitwise too;
    puts each kernel's largest absolute error into ``errors`` if given."""
    got = fb_cuda.prefix_matmul_scan_cuda(M)
    if want is None:
        want = fb.prefix_matmul_scan_reference(M.contiguous())
    check(got.shape == M.shape and torch.allclose(got, want, rtol=FB_RTOL, atol=FB_ATOL,
                                                  equal_nan=True),
          f"[fbscan] prefix kernel != plain beyond rtol {FB_RTOL} ({where})")
    check(torch.equal(fb_cuda.suffix_compose_scan_cuda(maps),
                      fb.suffix_compose_scan_reference(maps.contiguous())),
          f"[fbscan] suffix kernel != plain ({where})")
    if errors is not None:
        errors.update(prefix_err=max_abs_err(got, want), suffix_err=0.0)
    return bits_equal(got, want)


def check_cross_shard(calls: list) -> int:
    """Each (kind, x) of ``calls`` (the sweep's cross-shard scans, strides
    as the sweep passed them) through its kernel against the plain version
    of its contiguous copy: the prefix within FB_RTOL / FB_ATOL, the suffix
    bitwise. Returns how many were bitwise."""
    bitwise = 0
    for kind, x in calls:
        if kind == "prefix":
            got = fb_cuda.prefix_matmul_scan_cuda(x)
            want = fb.prefix_matmul_scan_reference(x.contiguous())
            ok = torch.allclose(got, want, rtol=FB_RTOL, atol=FB_ATOL)
        else:
            got = fb_cuda.suffix_compose_scan_cuda(x)
            want = fb.suffix_compose_scan_reference(x.contiguous())
            ok = torch.equal(got, want)
        check(ok, f"[fbscan] {kind} kernel != plain on the sweep's cross-shard call "
              f"{tuple(x.shape)} strides {x.stride()}")
        bitwise += bits_equal(got, want)
    return bitwise


def phase_fbscan() -> dict:
    """[fbscan]: each FB scan kernel against its plain version on the card
    at FB_SIZES x FB_KS x FB_ROWS, at K = 17-32 FB_WIDE_SHAPES alone, at K =
    33-64 FB_DEEP_SHAPES (K = 64 also at (433,920, 1)), above K = 64
    FB_TILED_CASES (the prefix within FB_RTOL / FB_ATOL, also counting the
    cases that are bitwise, and bitwise at K > 32; the suffix bitwise), each
    row of a 4-row call bitwise equal to a one-row call on that row; at K =
    33-64 each prefix call one tiled-product kernel, above K = 64 one tiled
    kernel with j streamed, and each grouped suffix call above K = 64 the
    group, rows and combine kernels (scan_kernels); that the library holds
    none of the generic kernels (FB_GENERIC); a permuted and a transposed
    view (the shape of the sharded engine's cross-shard calls) against the
    plain versions of their contiguous copies, and NaN propagating as in the
    plain version. Not counted: callers reset the counters before the run
    they count."""
    res = {"cases": 0, "bitwise": 0, "prefix_err": 0.0, "suffix_err": 0.0, "worst_rel": 0.0,
           "subnormal_cases": 0}
    binary = fb_cuda.build().path.read_bytes()
    kept = [name for name in FB_GENERIC if name.encode() in binary]
    check(not kept, f"[fbscan] the built library still holds the generic kernels {kept}")
    cases = [(B, K, R) for B in FB_SIZES for K in FB_KS for R in FB_ROWS
             if not (16 < K <= 32 and (B, R) not in FB_WIDE_SHAPES
                     or 32 < K <= 64 and (B, R) not in FB_DEEP_SHAPES
                     and (K, B, R) != (64, FB_BIG, 1))]
    cases += [(B, K, R) for K, B, R in FB_TILED_CASES + FB_HUGE_CASES]
    for B, K, R in cases:
        M, maps = fb_inputs(B, K, R, B * 100 + K * 10 + R)
        where = f"B={B} K={K} R={R}"
        got = fb_cuda.prefix_matmul_scan_cuda(M)
        want = fb.prefix_matmul_scan_reference(M)
        check(got.shape == M.shape and bool(torch.isfinite(got).all()),
              f"[fbscan] prefix kernel: shape or non-finite values ({where})")
        close = torch.allclose(got, want, rtol=FB_RTOL, atol=FB_ATOL)
        rel = float(((got - want).abs() / (FB_ATOL + want.abs())).max())
        check(close, f"[fbscan] prefix kernel != plain beyond rtol {FB_RTOL} ({where}, "
              f"largest relative error {rel:.3g})")
        bitwise = bits_equal(got, want)
        check(bitwise or K <= 32,
              f"[fbscan] prefix kernel not bitwise equal to its plain version ({where})")
        res["bitwise"] += bitwise
        res["cases"] += 1
        res["prefix_err"] = max(res["prefix_err"], max_abs_err(got, want))
        if K > 32:
            names = [n for n, _ in scan_kernels(lambda: fb_cuda.prefix_matmul_scan_cuda(M))]
            check(len(names) == 1 and (FB_DEEP if K <= 64 else FB_TILED)[0] in names[0],
                  f"[fbscan] a K = {K} prefix call ran {names} ({where})")
        res["worst_rel"] = max(res["worst_rel"], rel)
        sgot = fb_cuda.suffix_compose_scan_cuda(maps)
        check(torch.equal(sgot, fb.suffix_compose_scan_reference(maps)),
              f"[fbscan] suffix kernel != plain ({where})")
        if K > 64 and B > 256:
            names = [n for n, _ in scan_kernels(lambda: fb_cuda.suffix_compose_scan_cuda(maps))]
            check(suffix_grouped(K, names), f"[fbscan] a grouped K = {K} suffix call ran {names} "
                  f"({where})")
        if R > 1:
            for r in range(R):
                check(bits_equal(got[:, :, r], fb_cuda.prefix_matmul_scan_cuda(
                    M[:, :, r:r + 1].contiguous())[:, :, 0]),
                      f"[fbscan] prefix row {r} of {R} != its one-row call ({where})")
                check(torch.equal(sgot[:, r], fb_cuda.suffix_compose_scan_cuda(
                    maps[:, r:r + 1].contiguous())[:, 0]),
                      f"[fbscan] suffix row {r} of {R} != its one-row call ({where})")
        del M, maps, got, want, sgot
    # the sweep's matrices: many exact zeros (underflowed emission weights), some subnormal
    # (at K > 32 also -0: 1 % of the entries)
    for B, K in ((384, 3), (29_696, 3), (29_696, 9), (29_696, 10), (29_696, 16), (29_696, 17),
                 (29_696, 27), (29_696, 32), (384, 33), (29_696, 33), (29_696, 48), (384, 64),
                 (29_696, 64), *((384, K) for K in (65, 81, 96, 128, 129, 160, 243))):
        M, _ = fb_inputs(B, K, 2, 99 + K)
        u = torch.rand(M.shape, generator=torch.Generator(device="cuda").manual_seed(B), device="cuda")
        M = torch.where(u < 0.4, 0.0, torch.where(u < 0.45, M * 1e-39, M))
        if K > 32:
            M = torch.where(u > 0.99, -0.0, M)
        got, want = fb_cuda.prefix_matmul_scan_cuda(M), fb.prefix_matmul_scan_reference(M)
        check(torch.allclose(got, want, rtol=FB_RTOL, atol=FB_ATOL)
              and (K <= 32 or bits_equal(got, want)),
              f"[fbscan] prefix kernel != plain with zeros and subnormals (B={B} K={K})")
        res["bitwise"] += bits_equal(got, want)
        res["cases"] += 1
        res["subnormal_cases"] += 1
    # above K = 512: the same with pieces of a row through the transposes (the infinity at B / 2)
    for B, K in FB_HUGE_SPECIAL:
        M, _ = fb_inputs(B, K, 2, 99 + K)
        u = torch.rand(M.shape, generator=torch.Generator(device="cuda").manual_seed(B), device="cuda")
        M = torch.where(u < 0.4, 0.0, torch.where(u < 0.45, M * 1e-39, M))
        M = torch.where(u > 0.99, -0.0, M)
        inf, _ = fb_inputs(B, K, 1, 55 + K)
        inf[0, 0, 0, B // 2] = float("inf")
        nan, _ = fb_inputs(B, K, 2, 77)
        nan[1, 2, 0, B // 3] = float("nan")
        for what, x in (("zeros, -0 and subnormals", M), ("an infinity", inf), ("NaN", nan)):
            got, want = fb_cuda.prefix_matmul_scan_cuda(x), fb.prefix_matmul_scan_reference(x)
            check(bits_equal(got, want) and (what != "NaN" or bool(torch.isnan(got).any())),
                  f"[fbscan] prefix kernel != plain with {what} (B={B} K={K})")
            res["bitwise"] += 1
            res["cases"] += 1
            res["subnormal_cases"] += 1
        del M, inf, nan, got, want
    # the sharded engine's cross-shard calls: a (P, K, K) permuted, a (P, K) transposed
    tots = torch.rand((P_SHARDED, 3, 3), device="cuda") + 0.05
    tmaps = torch.randint(0, 3, (P_SHARDED, 3), device="cuda")
    res["bitwise"] += check_scans(tots.permute(1, 2, 0), tmaps.T, "permuted and transposed views")
    res["cases"] += 1
    cross = fbscan_cross_cases()
    res["cross"] = cross["kernels"]
    res["bitwise"] += cross["bitwise"]
    res["cases"] += cross["cases"]
    # an infinity: its row's later products hold infinities and NaN, as in torch (K > 64)
    for K in (65, 81, 96, 128, 129, 160, 243):
        M, _ = fb_inputs(384, K, 1, 55 + K)
        M[0, 0, 0, 200] = float("inf")
        got, want = fb_cuda.prefix_matmul_scan_cuda(M), fb.prefix_matmul_scan_reference(M)
        check(bits_equal(got, want) and not bool(torch.isfinite(got).all()),
              f"[fbscan] an infinity (B=384 K={K})")
        res["bitwise"] += 1
        res["cases"] += 1
        res["subnormal_cases"] += 1
    # NaN: a NaN entry turns every later product of its row into NaN, as in torch
    for B, K in ((200, 3), (29_696, 3), (200, 9), (29_696, 9), (200, 27), (29_696, 27),
                 (200, 64), (29_696, 64), (200, 81), (384, 81), (384, 128), (384, 160),
                 (384, 243)):
        M, _ = fb_inputs(B, K, 2, 77)
        M[1, 2, 0, B // 3] = float("nan")
        got, want = fb_cuda.prefix_matmul_scan_cuda(M), fb.prefix_matmul_scan_reference(M)
        check(torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got).any())
              and torch.allclose(got, want, rtol=FB_RTOL, atol=FB_ATOL, equal_nan=True)
              and (K <= 32 or bits_equal(got, want)),
              f"[fbscan] NaN propagation (B={B} K={K})")
    torch.cuda.synchronize()
    return res


def suffix_grouped(K: int, names: list[str]) -> bool:
    """Whether ``names`` are the kernels of one grouped suffix call at K > 64:
    the group, rows and combine kernels (FB_SUFFIX_GROUPED), above
    FB_SUFFIX_FLAT_K the rows scan alone."""
    if K > FB_SUFFIX_FLAT_K:
        return len(names) == 1 and FB_SUFFIX_GROUPED[1] in names[0]
    return len(names) == 3 and all(k in n for k, n in zip(FB_SUFFIX_GROUPED, names))


def fbscan_cross_cases() -> dict:
    """The sharded sweep's cross-shard scans at K > 3 and P = 2-4 shards
    (FB_CROSS_CASES: flat calls at B = P): the (K, K, B) view of B shard
    totals and the (K, B) view of their maps, then their contiguous copies,
    against the plain versions (check_scans; bitwise at K > 32, where each
    prefix call must be one tiled-product kernel), and the CUDA kernels of
    one call of each on the contiguous copies."""
    res: dict = {"cases": 0, "bitwise": 0, "kernels": {}}
    for B, K in FB_CROSS_CASES:
        gen = torch.Generator(device="cuda").manual_seed(31 * B + K)
        tots = torch.rand((B, K, K), generator=gen, device="cuda").mul_(0.95).add_(0.05)
        tmaps = torch.randint(0, K, (B, K), generator=gen, device="cuda")
        views = (tots.permute(1, 2, 0), tmaps.T)
        for M, maps in (views, tuple(v.contiguous() for v in views)):
            where = f"cross-shard B={B} K={K} strides {M.stride()}"
            bitwise = check_scans(M, maps, where)
            check(bitwise or K <= 32, f"[fbscan] prefix kernel not bitwise equal to its plain "
                  f"version ({where})")
            res["bitwise"] += bitwise
            res["cases"] += 1
        kinds = {key: [kernel_label(n) for n, _ in scan_kernels(fn)] for key, fn in (
            ("prefix", lambda: fb_cuda.prefix_matmul_scan_cuda(M)),
            ("suffix", lambda: fb_cuda.suffix_compose_scan_cuda(maps)))}
        check(K <= 32 or len(kinds["prefix"]) == 1
              and (FB_DEEP if K <= 64 else FB_TILED)[0] in kinds["prefix"][0],
              f"[fbscan] a cross-shard K = {K} prefix call at B = {B} ran {kinds['prefix']}")
        res["kernels"][(B, K)] = kinds
    return res


def fb_work(B: int, K: int, R: int) -> dict:
    """(bytes, float32 operations) of one call of each scan: the input read
    once and the output written once; a combine of the prefix is K^2 (2K -
    1) multiplies and adds, K^2 maxes and K^2 divides, taken B log2(B)
    times flat, else 8 B + G log2(G) times (7 in-group levels, the totals,
    one broadcast combine); the suffix does no arithmetic."""
    G = B // 128
    grouped = B > 256 and B % 128 == 0
    combines = (8 * B + G * max(G - 1, 0).bit_length()) if grouped else B * max(B - 1, 0).bit_length()
    return {
        "prefix": (8 * K * K * R * B, R * combines * K * K * (2 * K + 1)),
        "suffix": (16 * K * R * B, 0),
    }


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_bytes", ctypes.c_uint), ("params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def scan_kernels(fn) -> list[tuple[str, int]]:
    """(symbol, CTAs) of each CUDA kernel one call of ``fn`` launches: one
    call, after a warm-up call, captured into a CUDA graph, whose kernel
    nodes libcuda lists (cuGraphGetNodes, cuGraphKernelNodeGetParams,
    cuFuncGetName). Copies and memsets are not kernels. Not torch.profiler:
    on the H100 host it now and then drops kernels of a traced call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kernels = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)) == 0
              and cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)) == 0,
              "libcuda could not name a kernel node")
        kernels.append((name.value.decode(), params.grid[0] * params.grid[1] * params.grid[2]))
    del graph
    return kernels


def flushed(flush: torch.Tensor):
    """A ``before`` for time_ms: write ``flush`` (no input left in L2), then
    sleep on the card while the host queues the timed call, so that a call
    whose host side outlasts the flush still times device work only."""
    def before():
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES // 20)
    return before


def time_fbscan(inputs: dict, reps: int | None = None) -> dict:
    """For each tag -> (M, maps) of ``inputs``: each FB scan kernel checked
    against its plain version on those inputs (check_scans), the CUDA
    kernels one call of each launches, then CUDA-event times (L2 flushed,
    and warm) of both and of their plain versions, beside the least time on
    the card; ``reps`` repetitions of each, if given (the plain versions at
    K > 64 one)."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    timed = {}
    for tag, (M, maps) in inputs.items():
        K, B = M.shape[0], M.shape[-1]
        R = M.numel() // (K * K * B)
        row = {"shape": (B, K, R)}
        want = None
        if K > 512:  # the plain prefix's K^3 combines take seconds: one timed call, whose result
            # the check takes
            flush.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = fb.prefix_matmul_scan_reference(M.contiguous())
            torch.cuda.synchronize()
            row["prefix_plain"] = 1e3 * (time.perf_counter() - t0)
        row["bitwise"] = check_scans(M, maps, tag, row, want)
        fns = {
            "prefix": lambda: fb_cuda.prefix_matmul_scan_cuda(M),
            "suffix": lambda: fb_cuda.suffix_compose_scan_cuda(maps),
            "prefix_plain": lambda: fb.prefix_matmul_scan_reference(M),
            "suffix_plain": lambda: fb.suffix_compose_scan_reference(maps),
        }
        for key in ("prefix", "suffix"):
            row[key + "_kernels"] = scan_kernels(fns[key])
        for name, fn in fns.items():
            # the plain versions' K^3 products take a second per call at K = 64, four at 128:
            # above 64 one repetition, flushed only; above 512 the prefix's the call above
            if name in row:
                row[name + "_warm"] = float("nan")
                continue
            plain = name.endswith("_plain")
            n = (1 if K > 64 else 5) if plain and K > 32 else TIMING_REPS if K <= 512 else 3
            n = min(n, reps) if reps else n
            row[name] = time_ms(fn, flushed(flush), n)
            row[name + "_warm"] = (float("nan") if plain and K > 64
                                   else time_ms(fn, lambda: torch.cuda._sleep(SLEEP_CYCLES), n))
        for name, (nbytes, ops) in fb_work(B, K, R).items():
            row[name + "_bound"], row[name + "_bound_by"] = bound_ms(nbytes, ops)
        timed[tag] = row
        del fns, want
    del flush
    torch.cuda.empty_cache()
    return timed


def model_stats_inputs(R: int, B: int, K: int, dim: int, seed: int,
                       tail: str = "full", P: int | None = None) -> tuple:
    """One statistics call's inputs, made on the card from ``seed``: (R, B)
    states and sizes, (R,) block counts (``tail``: B; "masked", about half,
    one fewer in each later row; "overflow", an overflowing sweep's B + 1),
    (dim, 2, R, B) signed block statistics and a (K, dim) mapping into P
    parameters (by default K at dim 1, else 2). Returns the kernel's
    arguments, P last."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = P or (K if dim == 1 else 2)
    states = torch.randint(0, K, (R, B), generator=gen, device="cuda")
    sizes = torch.randint(1, 400, (R, B), generator=gen, device="cuda")
    first = {"full": B, "masked": B // 2 + 1, "overflow": B + 1}[tail]
    n_blocks = first - (tail == "masked") * torch.arange(R, device="cuda")
    bstats = torch.randn((dim, 2, R, B), generator=gen, device="cuda").mul_(30)
    bstats[:, 1].abs_()
    mapping = torch.randint(0, P, (K, dim), generator=gen, device="cuda")
    return states, sizes, n_blocks, bstats, mapping, P


def stats_reference_in_chunks(states, sizes, n_blocks, bstats, mapping, P: int,
                              chunk: int = 1 << 16) -> torch.Tensor:
    """What sweep.sweep_stats_reference returns, for rows whose (R, terms,
    B) leaves would not fit the card (K = 81, dim 4 at B = 4M: 108 GB): the
    plain version's leaves, made for aligned chunks of ``chunk`` blocks (a
    power of two; the last zero-padded to it), each chunk's pairwise tree
    (sweep._pairwise_sum), then the tree over the chunk sums, zero-padded to
    the next power of two, then the plain version's assembly. The plain
    version's tree over B zero-padded to the next power of two splits at
    every aligned power-of-two node, so these are its bits
    (tests/test_torch_samplers.py holds this against it)."""
    R, B = states.shape
    K, dim = mapping.shape
    f32, dev = torch.float32, states.device
    if B <= chunk:
        return sweep.sweep_stats_reference(states, sizes, n_blocks, bstats, mapping, P)
    kk, pp = torch.arange(K, device=dev), torch.arange(P, device=dev)
    sums = []
    for c0 in range(0, B, chunk):
        n = min(chunk, B - c0)
        st, sz = states[:, c0:c0 + n], sizes[:, c0:c0 + n].to(f32)[:, None]
        prev = states[:, c0 - 1:c0 + n - 1] if c0 else torch.cat(
            [states.new_zeros((R, 1)), states[:, :n - 1]], dim=1)
        valid = (c0 + torch.arange(n, device=dev))[None, :] < n_blocks[:, None]
        at = ((st[:, None, :] == kk[None, :, None]) & valid[:, None, :]).to(f32)
        pairs = ((prev[:, None, None, :] == kk[None, :, None, None])
                 & (st[:, None, None, :] == kk[None, None, :, None]) & valid[:, None, None, :])
        pm = mapping[st]
        leaves = [at * sz, at * (sz - 1.0), pairs.reshape(R, K * K, n).to(f32)]
        del pairs
        for d in range(dim):
            routed = ((pm[:, None, :, d] == pp[None, :, None]) & valid[:, None, :]).to(f32)
            leaves += [routed * bstats[d, 0][:, None, c0:c0 + n],
                       routed * bstats[d, 1][:, None, c0:c0 + n], routed * sz]
        x = torch.nn.functional.pad(torch.cat(leaves, dim=1), (0, chunk - n))
        del leaves
        sums.append(sweep._pairwise_sum(x))
        del x
    terms = sweep._pairwise_sum(torch.stack(sums, dim=-1))
    state, diag = terms[:, :K], terms[:, K:2 * K]
    trans = terms[:, 2 * K:2 * K + K * K].reshape(R, K, K) + torch.diag_embed(diag)
    theta = torch.zeros((R, 3 * P), dtype=f32, device=dev)
    for d in range(dim):
        at_d = 2 * K + K * K + 3 * P * d
        theta = theta + terms[:, at_d:at_d + 3 * P]
    return torch.cat([theta, trans.reshape(R, K * K), state], dim=1)


def model_resample_inputs(K: int, seed: int, nan: bool = False) -> tuple:
    """One resample call's inputs, made on the card from ``seed``: priors,
    statistics of P = K parameters whose Gamma shapes span 0.5 to 1e7 (a NaN
    theta sum with ``nan``), and the noise drawn as the resample draws it.
    Returns the 12 tensors the kernel takes: priors, statistics, noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P, n = K, 2 * K + K * K
    spread = torch.tensor([0.0, 1.0, 7.0, 120.0, 5e4, 1e7], device="cuda")
    pick = lambda *shape: spread[torch.randint(0, 6, shape, generator=gen, device="cuda")]  # noqa: E731
    counts = pick(P)
    sums = torch.randn(P, generator=gen, device="cuda") * counts
    if nan:
        counts[0], sums[0] = 40.0, float("nan")
    priors = hmm.HMMPriors.create(np.tile(np.array([2.0, 0.4, 0.1, 0.3], np.float32), (P, 1)),
                                  K, device="cuda")
    stats = (sums, counts * 1.7 + 1.0, counts, pick(K, K), pick(K))
    noise = (torch.randn((model_cuda.TRIES, n), generator=gen, device="cuda"),
             torch.rand((model_cuda.TRIES, n), generator=gen, device="cuda"),
             torch.rand((n,), generator=gen, device="cuda"),
             torch.randn((P,), generator=gen, device="cuda"))
    return tuple(priors) + stats + noise


class ModelInputs:
    """While entered, keeps a copy of the inputs of every model-update
    kernel call (through model_cuda._stats and _resample, which the
    wrappers call after their checks), the last one of each kind and
    shape. Run an eager engine inside it to take the sweep's own
    statistics inputs and its resample's statistics and noise."""

    def __init__(self):
        self.seen: dict = {"stats": {}, "resample": {}}
        self.real = (model_cuda._stats, model_cuda._resample)

    def __enter__(self):
        real_stats, real_resample = self.real

        def stats(*args):
            self.seen["stats"][tuple(args[0].shape)] = tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            return real_stats(*args)

        def resample(*args):
            self.seen["resample"][tuple(args[0].shape)] = tuple(a.clone() for a in args)
            return real_resample(*args)

        model_cuda._stats, model_cuda._resample = stats, resample
        return self

    def __exit__(self, *exc):
        model_cuda._stats, model_cuda._resample = self.real

    def main(self) -> tuple:
        """(statistics arguments of the largest call, resample arguments)."""
        return tuple(max(self.seen[k].values(), key=lambda a: a[0].numel())
                     for k in ("stats", "resample"))


def resample_parts(args: tuple) -> tuple:
    """(HMMPriors, SweepStats, noise) of the resample kernel's 12 tensors."""
    return hmm.HMMPriors(*args[:3]), hmm.SweepStats(*args[3:8]), tuple(args[8:])


def check_model(stats_args: tuple, resample_args: tuple | None, where: str) -> dict:
    """The statistics kernel (and the resample kernel, unless None) against
    their plain versions on the card, bit for bit (NaN where the plain
    version has NaN), each row of a many-row call against its one-row call;
    returns the largest absolute errors where both sides are finite."""
    got = model_cuda.sweep_stats_cuda(*stats_args)
    want = sweep.sweep_stats_reference(*stats_args)
    check(bits_equal(got, want), f"[model] statistics kernel != plain ({where})")
    states, sizes, n_blocks, bstats, mapping, P = stats_args
    for r in range(states.shape[0] if states.shape[0] > 1 else 0):
        one = model_cuda.sweep_stats_cuda(states[r:r + 1], sizes[r:r + 1], n_blocks[r:r + 1],
                                          bstats[:, :, r:r + 1].contiguous(), mapping, P)
        check(bits_equal(got[r], one[0]), f"[model] statistics row {r} != its one-row call ({where})")
    finite = bool(torch.isfinite(got).all())
    err = {"stats": max_abs_err(got, want) if finite else 0.0, "resample": 0.0}
    if resample_args is not None:
        parts = resample_parts(resample_args)
        rgot = model_cuda.resample_model_cuda(*parts)
        rwant = hmm.resample_model_reference(*parts)
        for name, a, b in zip(hmm.HMMState._fields, rgot, rwant):
            check(bits_equal(a, b), f"[model] resample kernel != plain: {name} ({where})")
            if bool(torch.isfinite(a).all()):
                err["resample"] = max(err["resample"], max_abs_err(a, b))
    return err


def check_large_stats(rows: list) -> dict:
    """The statistics kernel against its plain version at each (R, B, K,
    dim, P) of ``rows``, bit for bit: above B = 262,144 against the plain
    version's sums taken in chunks (stats_reference_in_chunks), which are
    checked against the plain version itself at smaller B."""
    res = {"cases": 0, "stats_err": 0.0}
    for R, B, K, dim, P in rows:
        args = model_stats_inputs(R, B, K, dim, B + K + dim, P=P)
        where = f"R={R} B={B} K={K} dim={dim} P={P}"
        got = model_cuda.sweep_stats_cuda(*args)
        if B > 262_144:
            want = stats_reference_in_chunks(*args)
        else:
            want = sweep.sweep_stats_reference(*args)
            check(bits_equal(stats_reference_in_chunks(*args, chunk=1 << 14), want),
                  f"[model] the plain statistics in chunks != the plain version ({where})")
        check(bits_equal(got, want), f"[model] statistics kernel != plain ({where})")
        res["stats_err"] = max(res["stats_err"], max_abs_err(got, want))
        res["cases"] += 1
        del args, got, want
        torch.cuda.empty_cache()
    return res


def phase_model() -> dict:
    """[model]: the statistics kernel against its plain version on the
    card at MODEL_ROWS x MODEL_KS x MODEL_DIMS (at B = 29,696 also a masked
    tail and an overflowing count), each row of a 4-row call against its
    one-row call; the resample kernel against its plain version over
    MODEL_DRAWS draws at each of MODEL_KS; both at K = 64, dim 3 at
    MODEL_K64_ROWS; both with NaN statistics. Not
    counted: callers reset the counters before the run they count."""
    res = {"cases": 0, "draws": 0, "stats_err": 0.0, "resample_err": 0.0}
    for R, B in MODEL_ROWS:
        for K in MODEL_KS:
            for dim in MODEL_DIMS:
                for tail in ("full", "masked", "overflow") if B == 29_696 else ("full",):
                    args = model_stats_inputs(R, B, K, dim, B + 10 * K + dim, tail)
                    err = check_model(args, None, f"R={R} B={B} K={K} dim={dim} {tail}")
                    res["stats_err"] = max(res["stats_err"], err["stats"])
                    res["cases"] += 1
                    del args
    # K = 64 dim 3 ([states64]'s) at 256 tiles of blocks: the run stacks of all 4,260 terms in
    # shared memory (the M burn-in runs at B = 4M, whose plain version would take 67 GB)
    for R, B in MODEL_K64_ROWS:
        args = model_stats_inputs(R, B, 64, 3, B + 643)
        err = check_model(args, model_resample_inputs(64, 64), f"R={R} B={B} K=64 dim=3")
        res["stats_err"] = max(res["stats_err"], err["stats"])
        res["cases"] += 1
        del args
    # above K = 64: the run stacks and histogram of the pair terms in slices where a CTA cannot
    # hold them all; the sharded M burn-in's four rows
    large = check_large_stats(MODEL_LARGE_K + MODEL_SHARDED_ROWS + MODEL_HUGE_K)
    res["cases"] += large["cases"]
    res["stats_err"] = max(res["stats_err"], large["stats_err"])
    for K in MODEL_RESAMPLE_KS:
        for draw in range(3):
            parts = resample_parts(model_resample_inputs(K, 7 * K + draw))
            rgot = model_cuda.resample_model_cuda(*parts)
            rwant = hmm.resample_model_reference(*parts)
            for name, a, b in zip(hmm.HMMState._fields, rgot, rwant):
                check(bits_equal(a, b), f"[model] resample kernel != plain: {name} (K={K} draw {draw})")
                res["resample_err"] = max(res["resample_err"], max_abs_err(a, b))
            res["draws"] += 1
    for K in MODEL_KS:
        stats_args = model_stats_inputs(1, 29_696, K, 1, K)
        for draw in range(MODEL_DRAWS):
            err = check_model(stats_args, model_resample_inputs(K, 1000 * K + draw),
                              f"K={K} draw {draw}")
            res["resample_err"] = max(res["resample_err"], err["resample"])
            res["draws"] += 1
    # NaN: a NaN block statistic poisons its dimension's theta sums, a NaN
    # theta sum its parameter's mean and variance, as in the plain versions
    args = model_stats_inputs(2, 29_696, 3, 1, 5, "masked")
    args[3][0, 0, 0, 100] = float("nan")
    args[3][0, 1, 1, 29_000] = float("nan")  # past row 1's blocks
    check_model(args, model_resample_inputs(3, 6, nan=True), "NaN")
    check(bool(torch.isnan(model_cuda.sweep_stats_cuda(*args)).any()), "[model] NaN was dropped")
    torch.cuda.synchronize()
    return res


def model_kernels_per_call() -> dict:
    """The CUDA kernels one call launches (scan_kernels), at every shape
    phase_model checks: exactly one modelupdate_stats_kernel per
    statistics call, one modelupdate_resample_kernel per resample call."""
    cases = 0
    for R, B in MODEL_ROWS:
        for K in MODEL_KS:
            for dim in MODEL_DIMS:
                for tail in ("full", "masked", "overflow") if B == 29_696 else ("full",):
                    args = model_stats_inputs(R, B, K, dim, B + 10 * K + dim, tail)
                    kern = scan_kernels(lambda: model_cuda.sweep_stats_cuda(*args))
                    check(len(kern) == 1 and "modelupdate_stats_kernel" in kern[0][0],
                          f"[model] one statistics call at R={R} B={B} K={K} dim={dim} {tail} "
                          f"ran {kern}, not one CUDA kernel")
                    cases += 1
                    del args
    for R, B, K, dim, P in MODEL_LARGE_K + MODEL_SHARDED_ROWS + MODEL_HUGE_K:
        args = model_stats_inputs(R, B, K, dim, B + K + dim, P=P)
        kern = scan_kernels(lambda: model_cuda.sweep_stats_cuda(*args))
        check(len(kern) == 1 and "modelupdate_stats_kernel" in kern[0][0],
              f"[model] one statistics call at R={R} B={B} K={K} dim={dim} ran {kern}")
        cases += 1
        del args
    for K in MODEL_KS + MODEL_RESAMPLE_KS:
        parts = resample_parts(model_resample_inputs(K, K))
        kern = scan_kernels(lambda: model_cuda.resample_model_cuda(*parts))
        check(len(kern) == 1 and "modelupdate_resample_kernel" in kern[0][0],
              f"[model] one resample call at K={K} ran {kern}")
    torch.cuda.empty_cache()
    return {"cases": cases}


def model_work(R: int, B: int, K: int, dim: int, P: int) -> dict:
    """(bytes, float32 operations) of one call of each kernel: every input
    read once and every output written once; the statistics' terms (2K +
    K^2 + 3 P dim of them) take a multiply and an add per block, and a
    Gamma shape's tries about 32 operations each (a transcendental counted
    as one), for n = P + K^2 + K shapes."""
    n, terms = P + K * K + K, 2 * K + K * K + 3 * P * dim
    return {
        "stats": (R * B * (16 + 8 * dim) + 8 * R + 8 * K * dim + 4 * R * (3 * P + K * K + K),
                  2 * terms * R * B),
        "resample": (4 * (7 * P + 2 * K * K + 2 * K + 2 * model_cuda.TRIES * n + n + P)
                     + 4 * (2 * P + K * K + K), n * (model_cuda.TRIES * 32 + 8)),
    }


def time_model(inputs: dict, reps: int = TIMING_REPS) -> dict:
    """For each tag -> (statistics arguments, resample arguments) of
    ``inputs``: both kernels checked against their plain versions on those
    inputs (check_model), the CUDA kernels one call of each launches, then
    CUDA-event times (L2 flushed, and warm, ``reps`` repetitions) of both
    and of their plain versions, beside the least time on the card."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    timed = {}
    for tag, (stats_args, resample_args) in inputs.items():
        err = check_model(stats_args, resample_args, tag)
        states, _, _, _, mapping, P = stats_args
        (R, B), (K, dim) = states.shape, mapping.shape
        parts = resample_parts(resample_args)
        fns = {
            "stats": lambda: model_cuda.sweep_stats_cuda(*stats_args),
            "resample": lambda: model_cuda.resample_model_cuda(*parts),
            "stats_plain": lambda: sweep.sweep_stats_reference(*stats_args),
            "resample_plain": lambda: hmm.resample_model_reference(*parts),
        }
        row = {"model_shape": (R, B, K, dim), "stats_kernels": scan_kernels(fns["stats"]),
               "resample_kernels": scan_kernels(fns["resample"]), "stats_err": err["stats"],
               "resample_err": err["resample"]}
        for name, fn in fns.items():
            row[name] = time_ms(fn, flushed(flush), reps)
            row[name + "_warm"] = time_ms(fn, lambda: torch.cuda._sleep(SLEEP_CYCLES), reps)
        for name, (nbytes, ops) in model_work(R, B, K, dim, P).items():
            row[name + "_bound"], row[name + "_bound_by"] = bound_ms(nbytes, ops)
        timed[tag] = row
        del fns
    del flush
    torch.cuda.empty_cache()
    return timed


def large_input(T: int, dim: int) -> torch.Tensor:
    """(T, dim) float32 N(1, 2) made on the card from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + T + dim)
    return torch.randn((T, dim), generator=gen, device="cuda").mul_(2).add_(1)


def transform_kernel_count() -> tuple[int, list[str]]:
    """CUDA kernels of one maxlet_transform_cuda call at T_MAIN, counted by
    torch.profiler in a child process: a process that has run the profiler
    launches more slowly, which would lower every later phase's rates."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), PROFILE_FLAG],
        capture_output=True, text=True, timeout=300, cwd=here,
    )
    check(proc.returncode == 0, f"profiler child failed: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    return res["kernels"], res["names"]


def profile_transform() -> int:
    """The child of transform_kernel_count: prints the CUDA kernels (no
    memcpy or memset) that one warm transform call runs."""
    x = torch.from_numpy(synth(T_MAIN, SEED)[0][:, None]).cuda()
    wavelet_cuda.maxlet_transform_cuda(x)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ])
    with prof:
        wavelet_cuda.maxlet_transform_cuda(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    print(json.dumps({"kernels": len(names), "names": names}), flush=True)
    return 0


def read_marginals(path: str) -> tuple[np.ndarray, np.ndarray]:
    rows = [list(map(int, line.split("\t"))) for line in open(path).read().splitlines()]
    K = max(len(r) - 1 for r in rows)
    sizes = np.array([r[0] for r in rows], dtype=np.int64)
    counts = np.zeros((len(rows), K), dtype=np.int64)
    for i, r in enumerate(rows):
        counts[i, : len(r) - 1] = r[1:]
    return sizes, counts


def phase_main_path() -> dict:
    data, truth = synth(T_MAIN, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "smoke-")
        rec = Records(
            T_MAIN, prefix, ".csv", 3,
            outputs={"marginals", "parameters", "compression"}, overwrite=True,
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        eng = runner.make_engine(data, nr_params=3, seed=SEED, records=rec)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng.run_scheme(SCHEME.split())
        eng.finalize()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        sizes, counts = read_marginals(prefix + "marginals.csv")
        n_params = len(open(prefix + "parameters.csv").read().splitlines())
        n_comp = len(open(prefix + "compression.csv").read().splitlines())
        digests = {name: hashlib.sha256(open(prefix + name + ".csv", "rb").read()).hexdigest()
                   for name in ("marginals", "parameters")}

    check(eng.device.type == "cuda", f"engine ran on {eng.device}")
    check_graphed(eng, "[main]")
    check(eng.ing.weights_host is None, "ingest did not take the device path")
    for name, n in launches.items():
        check(n >= 1, f"the main path never launched {name}")
    check(int(sizes.sum()) == T_MAIN, f"marginal rows cover {sizes.sum()} positions")
    check(bool((counts.sum(axis=1) == N_RECORDED).all()), "marginal row sums != 128")
    check(n_params == N_RECORDED and n_comp == N_RECORDED, "stream line counts")
    agreement = map_agreement(sizes, counts, truth)
    check(agreement >= MAP_AGREEMENT_MIN, f"MAP agreement {agreement:.4f}")
    f_sweeps = sum(n for m, n, _ in eng.phase_log if m == "F")
    f_secs = sum(s for m, _, s in eng.phase_log if m == "F")
    return {
        "launches": launches,
        "setup_s": setup_s,
        "total_s": total_s,
        "phases": [(m, n, round(s, 4)) for m, n, s in eng.phase_log],
        "f_sweeps_per_s": f_sweeps / f_secs,
        "capacity": eng.capacity,
        "last_n_blocks": eng.last_n_blocks,
        "peak_mem_bytes": peak,
        "map_agreement": agreement,
        "captures": eng.phase_graphs.captures,
        "capture_s": eng.phase_graphs.capture_seconds,
        "sha256": digests,
        "engine": eng,
    }


def fb_golden() -> dict:
    """The FB sampler on the card against golden.reference.fb_gibbs_sweep:
    per-block state frequencies of FB_DRAWS draws each on a small model
    (the toy problem of tests/_torch_helpers.py, 10 blocks, 3 states, seed
    5), within the Monte-Carlo bound of tests/test_torch_samplers.py::
    test_fb_sampler_distribution_matches_golden: |f - f_golden| < 6 se +
    0.01 for every block and state. Returns the largest share of the bound
    used."""
    rng = np.random.default_rng(5)
    B, K = 10, 3
    N = rng.integers(1, 20, size=B)
    means_true = rng.choice([0.0, 3.0, -2.0], size=B)
    sums, sumsqs = np.zeros((B, 1)), np.zeros((B, 1))
    for b in range(B):
        x = rng.normal(means_true[b], 1.0, size=(N[b], 1))
        sums[b], sumsqs[b] = x.sum(axis=0), (x * x).sum(axis=0)
    mean = np.array([-2.0, 0.0, 3.0], dtype=np.float32)
    var = np.array([1.1, 0.9, 1.3], dtype=np.float32)
    A = rng.dirichlet(np.ones(K) * 2, size=K).astype(np.float32)
    pi = rng.dirichlet(np.ones(K)).astype(np.float32)
    mapping = np.arange(K)[:, None]

    def card(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    args = (card(np.stack([sums.T, sumsqs.T], axis=1)), card(N, torch.int32), card(B, torch.int64),
            card(mean), card(var), card(A), card(pi), card(mapping, torch.int64))
    gen = torch.Generator(device="cuda").manual_seed(42)
    ours = torch.stack([fb_sample_states(gen, *args, True) for _ in range(FB_DRAWS)]).cpu().numpy()
    golden_rng = np.random.default_rng(7)
    theirs = np.stack([
        golden.fb_gibbs_sweep(sums, sumsqs, N, mean, var, A, pi, mapping, golden_rng, True)
        for _ in range(FB_DRAWS)
    ])
    share = 0.0
    for b in range(B):
        f_ours = np.bincount(ours[:, b], minlength=K) / FB_DRAWS
        f_theirs = np.bincount(theirs[:, b], minlength=K) / FB_DRAWS
        se = np.sqrt(np.maximum(f_theirs * (1 - f_theirs), 1e-4) / FB_DRAWS)
        share = max(share, float((np.abs(f_ours - f_theirs) / (6 * se + 0.01)).max()))
    check(share < 1.0, f"FB sampler frequencies off the golden sampler's ({share:.3f} of the bound)")
    return {"blocks": B, "draws": FB_DRAWS, "share_of_bound": share}


def map_agreement(sizes: np.ndarray, counts: np.ndarray, truth: np.ndarray) -> float:
    """Share of positions whose MAP state is the true state, under the best
    relabelling: the matching of MAP states to true states with the most
    positions (scipy.optimize.linear_sum_assignment on the confusion counts;
    at K = 3 the best of the 3! permutations). The MAP state is int8 per
    position and the counts are taken in slices, so that T = 250M fits the
    host (int16 above K = 128)."""
    from scipy.optimize import linear_sum_assignment

    map_state = np.repeat(counts.argmax(axis=1).astype(np.int8 if counts.shape[1] <= 128
                                                       else np.int16), sizes)
    k_map, k_true = counts.shape[1], int(truth.max()) + 1
    conf = np.zeros(k_map * k_true, dtype=np.int64)
    for lo in range(0, len(truth), 1 << 24):
        conf += np.bincount(map_state[lo:lo + (1 << 24)].astype(np.int64) * k_true
                            + truth[lo:lo + (1 << 24)], minlength=k_map * k_true)
    conf = conf.reshape(k_map, k_true)
    rows, cols = linear_sum_assignment(conf, maximize=True)
    return float(conf[rows, cols].sum()) / len(truth)


def device_kernels(prof) -> list:
    """The CUDA kernels of a torch.profiler trace: its device events without
    memory copies and sets, and without the spans torch.distributed marks
    around each collective on the device's timeline ("nccl:all_reduce" and
    the like), which would count every collective twice."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset", "nccl:"))]


def profile_f(eng, iters: int = 64) -> tuple[float, float]:
    """CUDA kernels and device ms per sweep over ``F iters 4`` on a warm
    engine (torch.profiler)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ])
    with prof:
        eng.run("F", iters, 4)
    kernels = device_kernels(prof)
    return len(kernels) / iters, sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3


def phase_settled(eng, order: tuple = SETTLED_ORDER) -> dict:
    """Settled F-phase rates with and without the per-sweep streams on the
    [main] engine (its run is over and checked), in the turns of ``order``:
    marginals+parameters+compression (m), all streams with
    the drain on its worker thread (a), and all streams with the drain made
    inline on the launching thread (i, how the port drained before the
    worker). Each phase runs SETTLED_ITERS sweeps, at least three chunks at
    the settled capacity. The host's rate drifts by tens of percent between
    runs, so each mode runs three times, once in each third of the order,
    and the ratios are given of the medians and of the best runs."""
    mpc = {"marginals", "parameters", "compression"}
    rates: dict = {"mpc": [], "all": [], "inline": []}
    busy: dict = {"all": [], "inline": []}
    waited: list[float] = []
    chunks: list[int] = []
    submit = runner.RecordDrain.submit
    old = os.environ.get("HAMMLET_DEBUG")
    with tempfile.TemporaryDirectory() as tmp:

        def run(tag: str, iters: int) -> None:
            eng.records = Records(
                T_MAIN, os.path.join(tmp, tag + "-"), ".csv", 3,
                outputs=mpc if tag == "mpc" else set(Records.STREAMS), overwrite=True,
            )
            if tag == "inline":  # run each drain at once on this thread
                runner.RecordDrain.submit = lambda self, fn, *args: self._timed(fn, args)
            eng.drain.busy.clear()
            eng.drain.waited.clear()
            try:
                eng.run("F", iters, 4)
            finally:
                runner.RecordDrain.submit = submit
            eng.records.close()
            rates[tag].append(iters / eng.phase_log[-1][2])
            if tag != "mpc":
                busy[tag].extend(1e3 * b for b in eng.drain.busy)
            if tag == "all":
                waited.extend(1e3 * w for w in eng.drain.waited)
                chunks.append(len(eng.drain.busy))

        try:
            os.environ["HAMMLET_DEBUG"] = "0"
            run("all", 128)  # warm-up of the state stacks and the formatters
            for key in ("all", "mpc"):
                rates[key].clear()
            for lst in (busy["all"], waited, chunks):
                lst.clear()
            for tag in order:
                run(tag, SETTLED_ITERS)
        finally:
            if old is None:
                del os.environ["HAMMLET_DEBUG"]
            else:
                os.environ["HAMMLET_DEBUG"] = old
    check(min(chunks) >= 3, f"a settled all-streams phase ran {chunks} chunks, not >= 3")
    mpc_rate, mpc_best = float(np.median(rates["mpc"])), max(rates["mpc"])
    return {
        "mpc_sweeps_per_s": rates["mpc"],
        "all_sweeps_per_s": rates["all"],
        "inline_sweeps_per_s": rates["inline"],
        "ratio": float(np.median(rates["all"])) / mpc_rate,
        "inline_ratio": float(np.median(rates["inline"])) / mpc_rate,
        "best_ratio": max(rates["all"]) / mpc_best,
        "inline_best_ratio": max(rates["inline"]) / mpc_best,
        "chunks": chunks,
        "capacity": eng.capacity,
        "drain_ms": float(np.median(busy["all"])),
        "inline_drain_ms": float(np.median(busy["inline"])),
        "waited_ms_per_chunk": float(np.sum(waited)) / max(sum(chunks), 1),
    }


def log_captures(eng) -> list:
    """(method, sweeps, graph captures, capture seconds) of each phase of
    ``eng`` as it runs (its ``run`` wrapped)."""
    log, pg, real = [], eng.phase_graphs, eng.run

    def run(method, iterations, thinning, start=0):
        captures, seconds = pg.captures, pg.capture_seconds
        real(method, iterations, thinning, start)
        log.append((method, iterations, pg.captures - captures, round(pg.capture_seconds - seconds, 4)))

    eng.run = run
    return log


def phase_graph(pairs: int = GRAPH_PAIRS) -> dict:
    """[graph]: SCHEME at T_MAIN through a graphed engine and through one
    whose chunks run the eager gibbs_phase, same seed: the same bytes,
    captures per phase, peak device memory of each (above what was
    allocated before it); then settled F SETTLED_ITERS 4 on both in
    ``pairs`` alternating pairs; then T_ONE_CARD with graphs."""
    data = synth(T_MAIN, SEED)[0]
    streams = ("marginals", "parameters", "compression")
    res: dict = {}
    engines: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for tag in ("graph", "eager"):
            prefix = os.path.join(tmp, tag + "-")
            rec = Records(T_MAIN, prefix, ".csv", 3, outputs=set(streams), overwrite=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng = runner.make_engine(data, nr_params=3, seed=SEED, records=rec)
            if tag == "eager":
                eager_engine(eng)
            log = log_captures(eng)
            eng.run_scheme(SCHEME.split())
            eng.finalize()
            torch.cuda.synchronize()
            res[tag] = {"peak_mem_bytes": torch.cuda.max_memory_allocated() - base,
                        "phases": [(m, n, round(t, 4)) for m, n, t in eng.phase_log],
                        "captures": list(log)}
            outs[tag] = {s: open(prefix + s + ".csv", "rb").read() for s in streams}
            engines[tag] = eng
        for s in streams:
            check(outs["graph"][s] == outs["eager"][s], f"[graph] {s}: the graphed engine's bytes "
                  "differ from the eager gibbs_phase engine's")
        check_graphed(engines["graph"], "[graph]")
        check(engines["eager"].phase_graphs.replays == 0, "[graph] the eager engine replayed graphs")
        rates: dict = {"graph": [], "eager": []}
        for turn, tag in enumerate(alternating("graph", "eager", pairs)):
            eng = engines[tag]
            eng.records = Records(T_MAIN, os.path.join(tmp, f"{tag}{turn}-"), ".csv", 3,
                                  outputs=set(streams), overwrite=True)
            eng.run("F", SETTLED_ITERS, 4)
            eng.records.close()
            rates[tag].append(SETTLED_ITERS / eng.phase_log[-1][2])
        res["settled"] = rates
        res["capacity"] = engines["graph"].capacity
        engines["eager"].records = None
        # the sweep's own matrices and maps, statistics inputs and resample inputs
        with ScanInputs() as scans, ModelInputs() as models:
            engines["eager"].run("F", 4, 4)
        res["scans"], res["models"] = scans, models
    del engines, eng
    torch.cuda.empty_cache()
    res["one_card"] = one_card_big()
    return res


def one_card_big() -> dict:
    """T_ONE_CARD positions of synth on the one card with graphs,
    ONE_CARD_SCHEME, marginals: setup seconds, M and F sweeps/s, peak
    device memory, captures; the marginal rows cover T and count the
    recorded sweeps, MAP agreement >= MAP_AGREEMENT_MIN."""
    data, truth = synth(T_ONE_CARD, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "big-")
        rec = Records(T_ONE_CARD, prefix, ".csv", 3, outputs={"marginals"}, overwrite=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = runner.make_engine(data, nr_params=3, seed=SEED, records=rec)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        log = log_captures(eng)
        eng.run_scheme(ONE_CARD_SCHEME.split())
        eng.finalize()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        sizes, counts = read_marginals(prefix + "marginals.csv")
    check_graphed(eng, "[graph] T_ONE_CARD")
    check(int(sizes.sum()) == T_ONE_CARD, f"[graph] big run: marginal rows cover {sizes.sum()}")
    check(bool((counts.sum(axis=1) == ONE_CARD_RECORDED).all()),
          f"[graph] big run: marginal rows do not count {ONE_CARD_RECORDED} sweeps")
    res = {"T": T_ONE_CARD, "setup_s": setup_s, "total_s": total_s, "peak_mem_bytes": peak,
           "capacity": eng.capacity, "rows": len(sizes), "captures": list(log),
           "phases": [(m, n, round(t, 4)) for m, n, t in eng.phase_log],
           "map_agreement": map_agreement(sizes, counts, truth)}
    check(res["map_agreement"] >= MAP_AGREEMENT_MIN, f"[graph] big run MAP agreement {res['map_agreement']:.4f}")
    for method in ("M", "F"):
        res[method] = (sum(n for m, n, _ in eng.phase_log if m == method)
                       / sum(t for m, _, t in eng.phase_log if m == method))
    return res


def phase_states9(tmp: str) -> dict:
    """[states9]: configuration 4 (config4_steps; K = 9 = 3^2, two tracks)
    through phase_tracks, and at its own T (CONFIG4_T) through
    bin/hammlet-torch -s C 3 2 -a."""
    return phase_tracks(tmp, "states9", config4_steps, STATES9_K, CONFIG4_T, ["C", "3", "2"])


def phase_states27(tmp: str) -> dict:
    """[states27]: three tracks, K = 27 = 3^3 (states27_steps, -s C 3 3)
    through phase_tracks, and at STATES27_CLI_T through bin/hammlet-torch -s
    C 3 3 -a."""
    return phase_tracks(tmp, "states27", states27_steps, STATES27_K, STATES27_CLI_T,
                        ["C", "3", "3"])


def phase_states64(tmp: str) -> dict:
    """[states64]: three tracks of four levels, K = 64 = 4^3
    (states64_steps, -s C 4 3) through phase_tracks, settled phases of
    STATES64_SETTLED_ITERS sweeps, and at STATES64_CLI_T through
    bin/hammlet-torch -s C 4 3 -a."""
    return phase_tracks(tmp, "states64", states64_steps, STATES64_K, STATES64_CLI_T,
                        ["C", "4", "3"], STATES64_SETTLED_ITERS)


def phase_states81(tmp: str) -> dict:
    """[states81]: four tracks of three levels, K = 81 = 3^4
    (states81_steps, -s C 3 4) through phase_tracks, settled phases of
    STATES81_SETTLED_ITERS sweeps, and at STATES81_CLI_T through
    bin/hammlet-torch -s C 3 4 -a."""
    return phase_tracks(tmp, "states81", states81_steps, STATES81_K, STATES81_CLI_T,
                        ["C", "3", "4"], STATES81_SETTLED_ITERS)


def phase_tracks(tmp: str, tag: str, steps, K: int, cli_T: int, states: list[str],
                 settled_iters: int = SETTLED_ITERS) -> dict:
    """[states9], [states27], [states64], [states81]: ``steps``' data (several tracks,
    K = P^tracks states) at T_MAIN positions through device ingest: make_engine ->
    SCHEME -> finalize through a graphed engine and through one whose
    chunks run the eager gibbs_phase, same seed. Checks that ingest took
    the device path and launched both maxlet kernels, that every kernel of
    the sweep launched, that every marginal row sums to the recorded
    sweeps, MAP agreement >= MAP_AGREEMENT_MIN, that every sweep of the
    graphed engine was a graph replay and that both engines wrote the same
    bytes; the peak device memory of setup and of each phase, with the
    capacity the phase ended at. Then settled F rates (TRACKS_SETTLED phases
    of ``settled_iters``), the maxlet kernels' times at this dim on this data,
    the sweep's own scan and model-update inputs (recorded from the eager
    engine), and the same data at cli_T through bin/hammlet-torch -s
    ``states`` -a in a subprocess (host ingest). Returns the engines too,
    for [profile]."""
    data, truth = steps(T_MAIN)
    dim = data.shape[1]
    streams = ("marginals", "parameters", "compression")
    res: dict = {"K": K, "dim": dim, "settled_iters": settled_iters}
    engines, outs = {}, {}
    for kind in ("graph", "eager"):
        prefix = os.path.join(tmp, f"{tag}-{kind}-")
        rec = Records(T_MAIN, prefix, ".csv", K, outputs=set(streams), overwrite=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        eng = runner.make_engine(data, nr_params=int(states[1]), nr_data_dim=dim, seed=SEED,
                                 records=rec)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        peaks = [("setup", 0, torch.cuda.max_memory_allocated() - base, eng.capacity)]
        if kind == "eager":
            eager_engine(eng)
        log = log_captures(eng)
        log_peaks(eng, base, peaks)
        eng.run_scheme(SCHEME.split())
        eng.finalize()
        torch.cuda.synchronize()
        res[kind] = {"setup_s": setup_s, "total_s": time.perf_counter() - t0,
                     "peak_mem_bytes": max(p for _, _, p, _ in peaks), "peaks": peaks,
                     "launches": read_counts(), "captures": list(log),
                     "phases": [(m, n, round(t, 4)) for m, n, t in eng.phase_log],
                     "capacity": eng.capacity}
        outs[kind] = {name: open(prefix + name + ".csv", "rb").read() for name in streams}
        if kind == "graph":
            sizes, counts = read_marginals(prefix + "marginals.csv")
        engines[kind] = eng
    g, e = engines["graph"], engines["eager"]
    where = f"[{tag}]"
    check(g.device.type == "cuda" and g.spec.nr_states == K,
          f"{where} engine on {g.device} with {g.spec.nr_states} states")
    check_graphed(g, where)
    check(e.phase_graphs.replays == 0, f"{where} the eager engine replayed graphs")
    check(g.ing.weights_host is None, f"{where} ingest did not take the device path")
    for name, n in res["graph"]["launches"].items():
        check(n >= 1, f"{where} the path never launched {name}")
    check(counts.shape[1] == K and int(sizes.sum()) == T_MAIN,
          f"{where} marginal rows of {counts.shape[1]} states cover {sizes.sum()} positions")
    check(bool((counts.sum(axis=1) == N_RECORDED).all()), f"{where} marginal row sums != {N_RECORDED}")
    res["map_agreement"] = map_agreement(sizes, counts, truth)
    check(res["map_agreement"] >= MAP_AGREEMENT_MIN,
          f"{where} MAP agreement {res['map_agreement']:.4f}")
    for name in streams:
        check(outs["graph"][name] == outs["eager"][name],
              f"{where} {name}: the graphed engine's bytes differ from the eager engine's")
    res["sha256"] = {name: hashlib.sha256(outs["graph"][name]).hexdigest()[:16]
                     for name in ("marginals", "parameters")}
    g.records = e.records = None
    rates = []
    for _ in range(TRACKS_SETTLED):
        g.run("F", settled_iters, 4)
        rates.append(settled_iters / g.phase_log[-1][2])
    res["settled"], res["settled_capacity"] = rates, g.capacity
    res["maxlet"] = maxlet_times(torch.from_numpy(data).cuda())
    with ScanInputs() as scans, ModelInputs() as models:
        e.run("F", 4, 4)
    res["scans"], res["models"] = scans, models
    res["cli"] = tracks_cli(tmp, tag, steps, K, cli_T, states)
    res["engines"] = engines
    return res


def phase_states625(tmp: str) -> dict:
    """[states625] (in a process of its own: STATES625_FLAG): four tracks of
    five levels, K = 625 = 5^4 (states625_steps, -s C 5 4) at STATES625_T
    positions a track through device ingest: make_engine ->
    STATES625_SCHEME -> finalize through a graphed engine and through one
    whose chunks run the eager gibbs_phase, same seed. Checks what
    phase_tracks checks: ingest on the device with both maxlet kernels,
    every kernel of the sweep launched, marginal rows that cover T and
    count the recorded sweeps, every sweep of the graphed engine a graph
    replay, the same bytes; in place of the MAP gate, the five levels in
    the burn-in's model (see STATES625_ENGINE_SEED; the MAP agreement is
    reported); the emission model and the peak device memory of setup and
    of each phase with the capacity it ended at.
    The graphed engine's graphs are released before the eager engine runs
    (two engines' transients at K = 625 would not fit beside each other).
    Then two settled F phases of STATES625_SETTLED_ITERS on the graphed
    engine and one eager F sweep whose scan and model-update inputs are
    kept; the CLI (cli.main, this process) on the same data as text, each
    of STATES625_CLI_RUNS with all seven streams (cli_tracks_prior: exit 0,
    the streams' checks, under a ceiling the first M chunk truncated at it,
    no recording chunk truncated, the MAP agreement reported; or exit 1,
    one error naming the capacity, K and HAMMLET_MAX_CAPACITY, nothing
    recorded); in all of these no plain
    version runs (PlainCalls). Last the maxlet kernels at dim 4 on this
    data (bitwise against their plain versions, on the card and the CPU,
    and timed) and the kept scan and model-update inputs checked against
    the plain versions and timed (the prefix against its plain version on
    the first STATES625_CHECK_B blocks, and alone at the whole capacity),
    and the prefix at STATES625_WIDE_B, past 2^31 entries a call
    (prefix_permutations). Returns only numbers and text (JSON)."""
    K, T, where = STATES625_K, STATES625_T, "[states625]"
    data, truth = states625_steps(T)
    dim = data.shape[1]
    streams = ("marginals", "parameters", "compression")
    n_rec = recorded_sweeps(STATES625_SCHEME)
    res: dict = {"K": K, "dim": dim, "T": T, "seconds": {}}
    last = [time.perf_counter()]

    def took(part: str) -> None:
        now = time.perf_counter()
        res["seconds"][part] = round(now - last[0], 1)
        last[0] = now

    outs, engines = {}, {}
    with PlainCalls() as plain:
        for kind in ("graph", "eager"):
            prefix = os.path.join(tmp, f"states625-{kind}-")
            rec = Records(T, prefix, ".csv", K, outputs=set(streams), overwrite=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            eng = runner.make_engine(data, nr_params=int(STATES625_STATES[1]), nr_data_dim=dim,
                                     seed=STATES625_ENGINE_SEED, records=rec)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            peaks = [("setup", 0, torch.cuda.max_memory_allocated() - base, eng.capacity)]
            if kind == "eager":
                eager_engine(eng)
            log = log_captures(eng)
            log_peaks(eng, base, peaks)
            models = log_models(eng)
            eng.run_scheme(STATES625_SCHEME.split())
            eng.finalize()
            torch.cuda.synchronize()
            res[kind] = {"setup_s": setup_s, "total_s": time.perf_counter() - t0,
                         "peak_mem_bytes": max(p for _, _, p, _ in peaks), "peaks": peaks,
                         "launches": read_counts(), "captures": list(log),
                         "phases": [(m, n, round(t, 4)) for m, n, t in eng.phase_log],
                         "capacity": eng.capacity, "models": models}
            outs[kind] = {name: open(prefix + name + ".csv", "rb").read() for name in streams}
            engines[kind] = eng
            eng.records = None
            if kind == "graph":
                sizes, counts = read_marginals(prefix + "marginals.csv")
                check_graphed(eng, where)
                check(eng.device.type == "cuda" and eng.spec.nr_states == K,
                      f"{where} engine on {eng.device} with {eng.spec.nr_states} states")
                check(eng.ing.weights_host is None, f"{where} ingest did not take the device path")
                for name, n in res[kind]["launches"].items():
                    check(n >= 1, f"{where} the path never launched {name}")
                _, means, varis = models[0]
                levels = np.array(sorted({a for m in STATES625_MEANS for a in m}))
                check(models[0][0] == "M" and all(np.abs(np.array(means) - v).min()
                                                  <= STATES625_LEVEL_TOL for v in levels)
                      and max(varis) < STATES625_VAR_MAX,
                      f"{where} the burn-in did not find the five levels: means {means}, "
                      f"variances {varis}")
                rates = []
                for _ in range(2):
                    eng.run("F", STATES625_SETTLED_ITERS, 4)
                    rates.append(STATES625_SETTLED_ITERS / eng.phase_log[-1][2])
                res["settled"], res["settled_capacity"] = rates, eng.capacity
                check_graphed(eng, where)
                res["replays"] = eng.phase_graphs.replays
                eng.phase_graphs.release()
                torch.cuda.empty_cache()
            took(kind)
            print(f"{where} {kind}: phases {res[kind]['phases']}, capacity {eng.capacity}, "
                  f"emission means and variances after each phase {models}", flush=True)
        e = engines["eager"]
        check(e.phase_graphs.replays == 0, f"{where} the eager engine replayed graphs")
        # the marginals hold the states up to the highest one sampled: at K = 625 on 625
        # segments some states are never drawn, the last few among them
        check(counts.shape[1] <= K and int(sizes.sum()) == T,
              f"{where} marginal rows of {counts.shape[1]} states cover {sizes.sum()} positions")
        check(bool((counts.sum(axis=1) == n_rec).all()), f"{where} marginal row sums != {n_rec}")
        res["map_agreement"] = map_agreement(sizes, counts, truth)  # reported: see
        # STATES625_ENGINE_SEED
        for name in streams:
            check(outs["graph"][name] == outs["eager"][name],
                  f"{where} {name}: the graphed engine's bytes differ from the eager engine's")
        res["sha256"] = {name: hashlib.sha256(outs["graph"][name]).hexdigest()[:16]
                         for name in ("marginals", "parameters")}
        del engines["graph"]
        with ScanInputs() as scans, ModelInputs() as models:
            e.run("F", 4, 4)
        del engines, e
        torch.cuda.empty_cache()
        path = os.path.join(tmp, "states625.csv")
        np.savetxt(path, data, fmt="%.5f")  # benchmarks/run_configs.py's _data_file format
        took("settled and inputs")
        res["cli"] = []
        for scheme, ceiling, method, rc in STATES625_CLI_RUNS:
            run = cli_tracks_prior(tmp, K, path, truth, STATES625_STATES, scheme, ceiling, T,
                                   method)
            del run["engine"]
            torch.cuda.empty_cache()
            check(run["rc"] == rc, f"{where} the CLI '{scheme}' under ceiling {ceiling} exited "
                  f"{run['rc']}, not {rc}")
            res["cli"].append(run)
        took("cli")
    check(not plain.calls, f"{where} plain versions ran: {plain.calls}")
    x_cpu = torch.from_numpy(data)
    worst = {"chunk": 0.0, "cross": 0.0, "transform": 0.0}
    check_kernels(x_cpu.cuda(), x_cpu, worst)
    res["maxlet"] = {**maxlet_times(x_cpu.cuda()), "worst": worst}
    res["sweep"] = states625_sweep_kernels(scans.main_and_others()[0], models.main())
    del scans, models
    torch.cuda.empty_cache()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    res["wide"] = [prefix_permutations(K, B, SEED + B, flush if B % 128 == 0 else None)
                   for B in STATES625_WIDE_B]
    del flush
    took("kernels")
    return res


def states625_sweep_kernels(scan_inputs: tuple, model_inputs: tuple) -> dict:
    """The [states625] sweep's own scan and model-update inputs: the prefix
    kernel against its plain version on the first STATES625_CHECK_B blocks
    of the sweep's matrices (bitwise, one tiled kernel a call) and both
    timed there (L2 flushed; the plain version once), the prefix kernel
    alone on the whole capacity (flushed, beside the bound), the suffix and
    both model-update kernels against their plain versions on the whole
    call (time_fbscan, time_model; one repetition of the plain versions)."""
    M, maps = scan_inputs
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    part = M[..., :STATES625_CHECK_B].contiguous()
    res = time_fbscan({"part": (part, maps[..., :STATES625_CHECK_B].contiguous())})["part"]
    K, B = M.shape[0], M.shape[-1]
    R = M.numel() // (K * K * B)
    check(res["bitwise"] and len(res["prefix_kernels"]) == 1
          and FB_TILED[0] in res["prefix_kernels"][0][0],
          f"[states625] the sweep's prefix on {STATES625_CHECK_B} blocks: bitwise "
          f"{res['bitwise']}, kernels {res['prefix_kernels']}")
    del part
    whole = {"shape": (B, K, R), "prefix_kernels": scan_kernels(
        lambda: fb_cuda.prefix_matmul_scan_cuda(M))}
    check(len(whole["prefix_kernels"]) == 1 and FB_TILED[0] in whole["prefix_kernels"][0][0],
          f"[states625] the sweep's prefix call ran {whole['prefix_kernels']}")
    whole["prefix"] = time_ms(lambda: fb_cuda.prefix_matmul_scan_cuda(M), flushed(flush), 3)
    whole["prefix_bound"], whole["prefix_bound_by"] = bound_ms(*fb_work(B, K, R)["prefix"])
    suffix = fb_cuda.suffix_compose_scan_cuda(maps)
    check(torch.equal(suffix, fb.suffix_compose_scan_reference(maps)),
          "[states625] suffix kernel != plain on the sweep's own maps")
    whole["suffix_kernels"] = scan_kernels(lambda: fb_cuda.suffix_compose_scan_cuda(maps))
    whole["suffix"] = time_ms(lambda: fb_cuda.suffix_compose_scan_cuda(maps), flushed(flush))
    whole["suffix_plain"] = time_ms(lambda: fb.suffix_compose_scan_reference(maps), flushed(flush), 1)
    whole["suffix_bound"], whole["suffix_bound_by"] = bound_ms(*fb_work(B, K, R)["suffix"])
    del flush, M, maps, suffix
    torch.cuda.empty_cache()
    model = time_model({"own": model_inputs}, reps=3)["own"]
    return {"part": res, "whole": whole, "model": model}


def prefix_permutations(K: int, B: int, seed: int, flush: torch.Tensor | None = None) -> dict:
    """The prefix kernel on B random K x K permutation matrices in one row
    (grouped where the plain version groups): each of their products is
    exact in any order (a sum of one product of ones and zeros; every
    matrix's max, so its scale, is 1), so the plain version's result is the
    prefix composition of the permutations, c_b = p_b o c_(b - 1), taken
    on the host without its K^3 combines. Checks that the call counts one
    launch and that its result is that bit for bit (ones at (i, c_b[i]),
    every entry nonnegative, the sum K B: every other entry +0); times it
    with L2 flushed if ``flush`` is given. The card's cache is emptied
    first: a call takes three tensors of K^2 B floats and more, the
    workspace of ~17.7 GB at K = 625, B = 6,016 in one piece. Returns the
    shape, K^2 B and the ms."""
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    perms = np.argsort(rng.random((B, K)), axis=1)
    cum, c = np.empty((K, B), dtype=np.int64), np.arange(K)
    for b in range(B):
        c = perms[b][c]
        cum[:, b] = c
    M = torch.zeros((K, K, B), device="cuda")
    M[torch.arange(K, device="cuda")[:, None], torch.from_numpy(perms.T).cuda(),
      torch.arange(B, device="cuda")[None]] = 1.0
    before = fb_cuda.prefix_matmul_scan_cuda.launches
    got = fb_cuda.prefix_matmul_scan_cuda(M)
    check(fb_cuda.prefix_matmul_scan_cuda.launches == before + 1,
          f"[states625] the prefix call on {B} permutations counted no launch")
    ones = got.gather(1, torch.from_numpy(cum).cuda()[:, None])
    check(bool((ones == 1).all()) and bool((got >= 0).all()) and float(got.sum(dtype=torch.float64))
          == K * B, f"[states625] the prefix kernel on {B} K = {K} permutations (K^2 B = "
          f"{K * K * B}) is not their composition")
    del got, ones
    res = {"shape": (B, K, 1), "entries": K * K * B}
    if flush is not None:
        res["ms"] = time_ms(lambda: fb_cuda.prefix_matmul_scan_cuda(M), flushed(flush), 3)
    del M
    torch.cuda.empty_cache()
    return res


def run_states625() -> dict:
    """[states625] in a child process (this script with STATES625_FLAG and
    a file for its result), started on a card that this process's engines
    do not hold: its result, its output lines and its seconds. A failed
    child fails the smoke with the child's message."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "states625.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), STATES625_FLAG, out],
                              capture_output=True, text=True, timeout=900, cwd=here)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0 and os.path.exists(out),
              f"[states625] the child exited {proc.returncode}: "
              f"{proc.stdout.splitlines()[-6:] or proc.stderr[-3000:]}")
        with open(out) as f:
            res = json.load(f)
    res["child_s"] = seconds
    return res


def states625_child(out: str) -> int:
    """STATES625_FLAG: phase_states625 in this process, its result as JSON
    into ``out``."""
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res = phase_states625(tmp)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", flush=True)
        return 1
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def print_states625(s: dict) -> None:
    g, e, sw = s["graph"], s["eager"], s["sweep"]
    mib = lambda peaks: [(m, n, round(p / 2**20, 1), cap) for m, n, p, cap in peaks]  # noqa: E731
    print(f"[states625] four tracks of five levels (-s C 5 4, K={s['K']}, states625_steps, seed "
          f"{STATES625_SEED}) T={s['T']} x {s['dim']} '{STATES625_SCHEME}' in a process of its own "
          f"({s['child_s']:.1f} s; parts {s['seconds']}): device ingest with both maxlet kernels; "
          f"graphed: setup {g['setup_s']:.3f} s, total {g['total_s']:.3f} s, phases {g['phases']}, "
          f"captures {g['captures']}, launches {g['launches']}; eager: total {e['total_s']:.3f} s, "
          f"phases {e['phases']}; same bytes; every graphed sweep a replay ({s['replays']}); "
          f"marginal rows count the {recorded_sweeps(STATES625_SCHEME)} recorded sweeps; the "
          f"burn-in found the five levels (emission means and variances after each phase "
          f"{g['models']}); MAP agreement {s['map_agreement']:.4f} (reported); sha256 "
          f"{s['sha256']}", flush=True)
    print(f"[states625] peak device memory above the engine's start (method, sweeps, MiB, capacity "
          f"at the phase's end): graphed {mib(g['peaks'])}, eager {mib(e['peaks'])}; settled F "
          f"{STATES625_SETTLED_ITERS} 4 sweeps/s {[round(r, 3) for r in s['settled']]} at capacity "
          f"{s['settled_capacity']}; maxlet at dim 4, flushed ms chunk {s['maxlet']['chunk']:.4f} "
          f"(bound {s['maxlet']['chunk_bound']:.4g}), cross {s['maxlet']['cross']:.4f}", flush=True)
    part, whole, m = sw["part"], sw["whole"], sw["model"]
    print(f"[states625] the sweep's own inputs (one eager F sweep, B={whole['shape'][0]}): prefix "
          f"kernel ({kernel_label(whole['prefix_kernels'][0][0])}, one launch) {whole['prefix']:.4f} "
          f"ms flushed (bound {whole['prefix_bound']:.4g} by {whole['prefix_bound_by']}, "
          f"{whole['prefix_bound'] / whole['prefix']:.1%}); on its first {STATES625_CHECK_B} blocks "
          f"bitwise {part['bitwise']}, {part['prefix']:.4f} ms (bound {part['prefix_bound']:.4g}), "
          f"plain {part['prefix_plain']:.4f}; suffix bitwise, {whole['suffix']:.4f} ms (bound "
          f"{whole['suffix_bound']:.4g}), kernels {[kernel_label(n) for n, _ in whole['suffix_kernels']]}, "
          f"plain {whole['suffix_plain']:.4f}; statistics bitwise {m['stats']:.4f} ms (bound "
          f"{m['stats_bound']:.4g}), plain {m['stats_plain']:.4f}; resample bitwise "
          f"{m['resample']:.4f} (bound {m['resample_bound']:.4g}), plain {m['resample_plain']:.4f}",
          flush=True)
    print(f"[states625] the prefix kernel past 2^31 entries (64-bit offsets), on permutation "
          f"matrices, bitwise their composition: "
          + "; ".join(f"B={w['shape'][0]} K^2 B={w['entries']}"
                      + (f" {w['ms']:.4f} ms flushed" if "ms" in w else "") for w in s["wide"]),
          flush=True)
    for run in s["cli"]:
        f = run["first"]
        print(f"[states625] bin/hammlet-torch -s C 5 4 '{run['scheme']}' all 7 streams, "
              f"HAMMLET_MAX_CAPACITY {run['ceiling'] or 'unset'}: exit {run['rc']} in "
              f"{run['seconds']:.2f} s; first {run['method']} chunk capacity {f['capacity']} (sweeps "
              f"needed up to "
              f"{f['max_nb']} blocks), peak {(f['peak'] or 0) / 2**20:.1f} MiB allocated above its "
              f"start; truncated chunks {run['truncated']}; phases {run['phases']}"
              + (f"; stream checks passed, MAP agreement {run['map_agreement']:.4f}"
                 if "map_agreement" in run else "")
              + (f"; error: {run['error']}" if "error" in run else ""), flush=True)


def maxlet_times(x: torch.Tensor) -> dict:
    """CUDA-event ms of each maxlet kernel and of its plain version on the
    card's (T, dim) ``x``, L2 flushed (FLUSH_BYTES written before each
    call), beside the least time on the card."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    before = flush.zero_
    kc, kt = wavelet_cuda.maxlet_chunks_cuda(x)
    buf = kc.clone()
    res = {
        "chunk": time_ms(lambda: wavelet_cuda.maxlet_chunks_cuda(x), before),
        "cross": time_ms(lambda: wavelet_cuda.maxlet_cross_cuda(buf, kt), before),
        "chunk_plain": time_ms(lambda: wavelet_cuda.maxlet_chunks_reference(x), before),
        "cross_plain": time_ms(lambda: wavelet_cuda.maxlet_cross_reference(buf, kt), before),
    }
    for name, (nbytes, ops) in transform_work(*x.shape).items():
        res[name + "_bound"], res[name + "_bound_by"] = bound_ms(nbytes, ops)
    del flush, kc, kt, buf
    torch.cuda.empty_cache()
    return res


def log_peaks(eng, base: int, peaks: list) -> None:
    """Append (method, sweeps, peak device memory above ``base``, capacity
    at the phase's end) to ``peaks`` for each phase of ``eng`` as it runs
    (its ``run`` wrapped; the peak statistic is reset before each phase)."""
    real = eng.run

    def run(method, iterations, thinning, start=0):
        torch.cuda.reset_peak_memory_stats()
        real(method, iterations, thinning, start)
        torch.cuda.synchronize()
        capacity = eng.cap_local if isinstance(eng, sharded.ShardedEngine) else eng.capacity
        peaks.append((method, iterations, torch.cuda.max_memory_allocated() - base, capacity))

    eng.run = run


def log_models(eng) -> list:
    """A list that gets (method, emission means, emission variances), as
    lists of floats rounded to 3 places, after each phase of ``eng`` (its
    ``run`` wrapped)."""
    models: list = []
    real = eng.run

    def run(method, *args, **kwargs):
        real(method, *args, **kwargs)
        models.append((method, [round(float(v), 3) for v in eng.model.theta_mean.cpu()],
                       [round(float(v), 3) for v in eng.model.theta_var.cpu()]))

    eng.run = run
    return models


def tracks_cli(tmp: str, tag: str, steps, K: int, T: int, states: list[str]) -> dict:
    """``steps``' data at T positions (below ingest_device's threshold:
    host ingest) through bin/hammlet-torch -s ``states`` -a SCHEME in a
    subprocess, marginals and parameters: the run is on the card, every
    marginal row sums to the recorded sweeps and MAP agreement >=
    MAP_AGREEMENT_MIN."""
    data, truth = steps(T)
    path = os.path.join(tmp, f"{tag}.csv")
    np.savetxt(path, data, fmt="%.5f")  # benchmarks/run_configs.py's _data_file format
    prefix = os.path.join(tmp, f"{tag}-cli-")
    here = os.path.dirname(os.path.abspath(__file__))
    what = f"[{tag}] bin/hammlet-torch -s {' '.join(states)}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "bin", "hammlet-torch"), "-f", path, "-s", *states,
         "-a", "-R", str(SEED), "-i", *SCHEME.split(), "-O", "marginals", "parameters", "-o", prefix, ".csv", "-w",
         "-v"], capture_output=True, text=True, timeout=600, cwd=here)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} failed: {proc.stderr[-2000:]}")
    check("Device: cuda" in proc.stdout + proc.stderr,
          f"{what} did not run on the card: {proc.stdout[-1000:]}")
    sizes, counts = read_marginals(prefix + "marginals.csv")
    check(counts.shape[1] == K and int(sizes.sum()) == T
          and bool((counts.sum(axis=1) == N_RECORDED).all()),
          f"{what}: marginal rows do not cover T or count the recorded sweeps")
    agreement = map_agreement(sizes, counts, truth)
    check(agreement >= MAP_AGREEMENT_MIN, f"{what} MAP agreement {agreement:.4f}")
    return {"seconds": seconds, "map_agreement": agreement, "rows": len(sizes)}


class PlainCalls:
    """While entered, counts the calls of the plain versions of the FB scans
    and of the model update (fb.prefix_matmul_scan_reference,
    fb.suffix_compose_scan_reference, sweep.sweep_stats_reference,
    hmm.resample_model_reference), through the module attributes the
    sweep's dispatch calls. On the card the wrappers launch their kernels or
    raise: a count above 0 means a sweep ran a plain version."""

    FUNCTIONS = ((fb, "prefix_matmul_scan_reference"), (fb, "suffix_compose_scan_reference"),
                 (sweep, "sweep_stats_reference"), (hmm, "resample_model_reference"))

    def __enter__(self):
        self.calls: dict = {}
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.FUNCTIONS]
        for mod, name, fn in self.saved:
            def counted(*args, _name=name, _fn=fn, **kwargs):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*args, **kwargs)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def kernel_base(name: str) -> str:
    """The identifier of a CUDA kernel of csrc/ from its mangled symbol or
    its demangled signature: fbscan_prefix_tiled_kernel<5>(float const*,
    ...) -> fbscan_prefix_tiled_kernel."""
    import re

    m = re.search(r"(fbscan_\w+?|modelupdate_\w+?)(?:ILi|I[a-z]E|<|\(|$)", kernel_label(name))
    return m.group(1) if m else name


def sharded_tracks_cases() -> tuple:
    """(tag, steps, K, -s arguments, scheme, settled sweeps) of each
    configuration [sharded_tracks] runs: the data of [states9], [states27],
    [states64] and [states81]."""
    return tuple(
        (tag, steps, K, states, SCHEME if K <= 27 else SHARDED_TRACKS_CUT_SCHEME,
         SHARDED_TRACKS_SETTLED[K])
        for tag, steps, K, states in (
            ("states9", config4_steps, STATES9_K, ["C", "3", "2"]),
            ("states27", states27_steps, STATES27_K, ["C", "3", "3"]),
            ("states64", states64_steps, STATES64_K, ["C", "4", "3"]),
            ("states81", states81_steps, STATES81_K, ["C", "3", "4"])))


def recorded_sweeps(scheme: str) -> int:
    """The sweeps a scheme records: iterations // thinning of each phase
    whose thinning is above 0."""
    return sum(op[2] // op[3] for op in runner.parse_scheme(scheme.split())
               if op[0] == "run" and op[3] > 0)


def phase_sharded_tracks(tmp: str, tag: str, steps, K: int, states: list[str], scheme: str,
                         settled_iters: int) -> dict:
    """[sharded_tracks] for one configuration: ``steps``' data (several
    tracks, K states, T_MAIN positions per track) through the sharded
    engine with P_SHARDED shards on the one card, make_sharded_engine ->
    ``scheme`` -> finalize, through a graphed engine and through one whose
    chunks run the eager sharded_phase (the same ingest: the second engine
    is the first's dataclasses.replace before either runs). Checks (a) that
    the sharded host ingest's breakpoint weights equal ingest_device's at
    this dim (the maxlet kernels) bit for bit, (b) that both engines write
    the same bytes (marginals, parameters, compression), (c) that the
    marginal rows cover T and sum to the recorded sweeps, (d) MAP agreement
    >= MAP_AGREEMENT_MIN, (e) that every sweep of the graphed engine was a
    graph replay, and that neither the graphed run nor the eager one called
    a plain version (PlainCalls) while every kernel of the sweep launched;
    the peak device memory of setup and of each phase, with the capacity per
    shard at its end; then settled F rates (TRACKS_SETTLED phases of
    ``settled_iters``); then, at the graphed engine's settled state and
    capacity, one eager chunk of F 4 4 through sharded_phase that records
    the sweep's own scan and model-update inputs, and the CUDA kernels one
    call of each scan on them launches ([profile] holds the graphed sweep
    to them: (f)). Returns the graphed engine too, for [profile]."""
    data, truth = steps(T_MAIN)
    dim = data.shape[1]
    where = f"[sharded_tracks] K={K}"
    streams = ("marginals", "parameters", "compression")
    n_rec = recorded_sweeps(scheme)
    res: dict = {"tag": tag, "K": K, "dim": dim, "states": states, "scheme": scheme,
                 "settled_iters": settled_iters}
    t_phase = time.perf_counter()
    recs = {kind: Records(T_MAIN, os.path.join(tmp, f"{tag}-{kind}-"), ".csv", K,
                          outputs=set(streams), overwrite=True) for kind in ("graph", "eager")}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = sharded.make_sharded_engine(data, n_devices=P_SHARDED, nr_params=int(states[1]),
                                    nr_data_dim=dim, seed=SEED, records=recs["graph"],
                                    device="cuda")
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0
    peaks = [("setup", 0, torch.cuda.max_memory_allocated() - base, g.cap_local)]
    e = eager_sharded_engine(dataclasses.replace(g, records=recs["eager"]))
    check(g.spec.nr_states == K and g.device.type == "cuda",
          f"{where} engine of {g.spec.nr_states} states on {g.device}")
    # (a) the sharded host ingest's weights against the kernel-driven device ingest's
    before = read_counts()
    ref = runner.ingest_device(data, device="cuda")
    check(all(read_counts()[k] == before[k] + 1 for k in MAXLET_NAMES),
          f"{where} ingest_device did not launch each maxlet kernel once")
    weights = torch.empty_like(g.negw).scatter_(1, g.rank, -g.negw).reshape(-1)[:T_MAIN]
    check(bits_equal(weights, ref.weights),
          f"{where} the sharded ingest's weights != ingest_device's (maxlet kernels, dim {dim})")
    del ref, weights
    torch.cuda.empty_cache()
    # the graphed run, then the eager one
    log = log_captures(g)
    log_peaks(g, base, peaks)
    reset_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        g.run_scheme(scheme.split())
        g.finalize()
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t0
        res["launches"] = read_counts()
        torch.cuda.reset_peak_memory_stats()
        e_base = torch.cuda.memory_allocated()
        e.run_scheme(scheme.split())
        e.finalize()
        torch.cuda.synchronize()
        res["eager_peak_mem_bytes"] = torch.cuda.max_memory_allocated() - e_base
    check(not plain.calls, f"{where} a plain version ran on the card: {plain.calls}")
    for name in SWEEP_NAMES:
        check(res["launches"][name] >= 1, f"{where} the graphed run never launched {name}")
    check_graphed(g, where)
    check(e.phase_graphs.replays == 0, f"{where} the eager engine replayed graphs")
    out = {kind: {s: open(os.path.join(tmp, f"{tag}-{kind}-{s}.csv"), "rb").read()
                  for s in streams} for kind in ("graph", "eager")}
    for s in streams:
        check(out["graph"][s] == out["eager"][s],
              f"{where} {s}: the graphed engine's bytes differ from the eager sharded_phase's")
    res["sha256"] = {s: hashlib.sha256(out["graph"][s]).hexdigest()[:16]
                     for s in ("marginals", "parameters")}
    sizes, counts = read_marginals(os.path.join(tmp, f"{tag}-graph-marginals.csv"))
    check(counts.shape[1] == K and int(sizes.sum()) == T_MAIN,
          f"{where} marginal rows of {counts.shape[1]} states cover {sizes.sum()} positions")
    check(bool((counts.sum(axis=1) == n_rec).all()), f"{where} marginal row sums != {n_rec}")
    res["rows"] = len(sizes)
    res["map_agreement"] = map_agreement(sizes, counts, truth)
    check(res["map_agreement"] >= MAP_AGREEMENT_MIN,
          f"{where} MAP agreement {res['map_agreement']:.4f}")
    pg = g.phase_graphs
    res.update(peaks=peaks, peak_mem_bytes=max(p for _, _, p, _ in peaks), captures=list(log),
               graphs=[pg.captures, pg.graphs, round(pg.capture_seconds, 4)],
               phases=[(m, n, round(t, 4)) for m, n, t in g.phase_log],
               eager_phases=[(m, n, round(t, 4)) for m, n, t in e.phase_log])
    g.records = None
    del e, out
    torch.cuda.empty_cache()
    rates = []
    with PlainCalls() as plain:
        for _ in range(TRACKS_SETTLED):
            g.run("F", settled_iters, 4)
            rates.append(settled_iters / g.phase_log[-1][2])
    check(not plain.calls, f"{where} a plain version ran in the settled phases: {plain.calls}")
    res["settled"], res["cap_local"] = rates, g.cap_local
    # the sweep's own inputs at the graphed engine's state and capacity, through the eager pieces
    candpos, candrank = g._shard_candidates()
    with ScanInputs() as scans, ModelInputs() as models:
        sharded.sharded_phase(
            g.mesh, g.seed, 10**6, g.model, g.priors, g.negw, candpos, candrank, g.r_t, g.q2_hi,
            g.q2_lo, g.buffers.clone(), None, method="F", T=g.T, T_local=g.T_local,
            cell_bits=g.cell_bits, mapping=g._mapping, nr_params=g.spec.nr_params,
            use_self_transitions=g.spec.use_self_transitions, n_iters=4, thinning=4)
    (M, maps), others = scans.main_and_others()
    check(sorted((k, v.shape[-1]) for k, v in others) == [("prefix", P_SHARDED), ("suffix", P_SHARDED)]
          and tuple(M.shape) == (K, K, P_SHARDED, g.cap_local),
          f"{where} the sweep's scan calls were {tuple(M.shape)} and "
          f"{[(k, tuple(v.shape)) for k, v in others]}")
    res["cross_bitwise"] = check_cross_shard(others)
    # the CUDA kernels of each scan call of one F sweep, and of the model update's two calls
    expected: dict = {}
    calls = [("prefix", M), ("suffix", maps)] + [(k, v.contiguous()) for k, v in others]
    for kind, x in calls:
        fn = fb_cuda.prefix_matmul_scan_cuda if kind == "prefix" else fb_cuda.suffix_compose_scan_cuda
        for name, _ in scan_kernels(lambda: fn(x)):
            expected[kernel_base(name)] = expected.get(kernel_base(name), 0) + 1
    for name in ("modelupdate_stats_kernel", "modelupdate_resample_kernel"):
        expected[name] = 1
    res.update(scans=(M, maps), models=models.main(), expected_per_sweep=expected,
               engine=g, seconds=time.perf_counter() - t_phase)
    return res


def check_sharded_tracks_profile(st: dict, p: dict) -> dict:
    """[sharded_tracks] (f): the hand-written kernels per settled sweep of
    the graphed P_SHARDED sweep (profile_launches ``p``) against the
    kernels the sweep's own calls launch (st["expected_per_sweep"]): each
    there, no more often than expected and at least 0.9 times as often
    (torch.profiler now and then drops a kernel of a traced call), and no
    other kernel of csrc/fbscan.cu or csrc/modelupdate.cu, none of the
    deleted generic kernels. Returns the per-sweep counts by kernel."""
    where = f"[sharded_tracks] K={st['K']} (f)"
    seen: dict = {}
    for name, (n, _) in {**p["fbscan"], **p["model"]}.items():
        seen[kernel_base(name)] = seen.get(kernel_base(name), 0.0) + n
        check(not any(gen in name for gen in FB_GENERIC_LABELS),
              f"{where} the graphed sweep ran a deleted generic kernel: {name}")
    want = st["expected_per_sweep"]
    check(set(seen) == set(want), f"{where} the graphed sweep's kernels {seen}, expected {want}")
    for name, n in want.items():
        check(0.9 * n <= seen[name] <= n + 1e-9,
              f"{where} {name}: {seen[name]} per sweep, expected {n} ({seen})")
    return seen


def profile_launches(eng, iters: int = 64) -> dict:
    """torch.profiler over ``F iters 4`` on a warm engine: per sweep, the
    CUDA runtime's launch calls by name (LAUNCH_CALLS), device kernels,
    their device ms summed and as the union of their intervals (a graph
    runs independent nodes at once, so the sum can exceed the time the
    device was busy), wall ms (the profiler's overhead included, so the
    busy share under it is a lower bound), and the ten costliest kernels
    by device time (name, launches per sweep, device ms per sweep), and
    the same for every FB scan kernel (csrc/fbscan.cu) and model-update
    kernel (csrc/modelupdate.cu)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ])
    torch.cuda.synchronize()
    with prof:
        t0 = time.perf_counter()
        eng.run("F", iters, 4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = device_kernels(prof)
    calls: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    by: dict = {}
    for e in kernels:
        n, us = by.get(e.name, (0, 0.0))
        by[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _, us in by.values()) / iters / 1e3
    union_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        union_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:10]
    fbscan, model = ({name: (n / iters, round(us / iters / 1e3, 5))
                      for name, (n, us) in sorted(by.items()) if prefix in name}
                     for prefix in ("fbscan_", "modelupdate_"))
    return {
        "launch_calls": {k: v / iters for k, v in sorted(calls.items())},
        "kernels": len(kernels) / iters,
        "device_ms": device_ms,
        "busy_ms": union_us / iters / 1e3,
        "wall_ms": wall_ms,
        "busy": union_us / iters / 1e3 / wall_ms,
        "top": [(name[:120], n / iters, round(us / iters / 1e3, 5)) for name, (n, us) in top],
        "fbscan": fbscan,
        "model": model,
    }


def split_stages() -> tuple:
    """(module, function name) of each stage of the sweep that
    device_split_by_stage labels, looked up where the sweep calls it."""
    return ((sweep, "sweep_step"), (sweep, "make_blocks_bucketed"),
            (sweep, "block_sufficient_stats_t"), (fb, "emission_log_weights_t"),
            (fb, "forward_columns_t"), (fb, "prefix_matmul_scan_t"), (fb, "backward_sample_t"),
            (fb, "gumbel"), (fb, "suffix_compose_scan_t"), (sweep, "accumulate_sweep_stats"),
            (sweep, "resample_model"), (sweep, "record_sweep"))


def device_split_by_stage(eng, iters: int = 16) -> dict:
    """torch.profiler over ``F iters 4`` of an engine whose chunks run
    eagerly, each function of split_stages() wrapped for the run in a
    torch.profiler.record_function range: the device ms per sweep of the
    kernels each stage launched outside the stages it calls (the innermost
    range among the ancestors of the operator that launched them), largest
    first, and their total. The FB scan and model-update kernels, launched
    through ctypes outside any torch operator, are credited to their stage
    by name; device time that no CPU event carries (the trace's device
    kernels less what was credited) is its own entry. Also the CUDA kernels
    per sweep, by name, of the two stages of the model update. A graph
    replays the same kernels, so this is the graphed sweep's split too."""
    def labelled(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function("stage:" + name):
                return fn(*args, **kwargs)
        return run

    saved = [(mod, name, getattr(mod, name)) for mod, name in split_stages()]
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ])
    try:
        for mod, name, fn in saved:
            setattr(mod, name, labelled(name, fn))
        with prof:
            eng.run("F", iters, 4)
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    by: dict = {}
    model_stages = ("accumulate_sweep_stats", "resample_model")
    names: dict = {stage: {} for stage in model_stages}
    by_name = (("fbscan_prefix", "prefix_matmul_scan_t"), ("fbscan_suffix", "suffix_compose_scan_t"),
               ("modelupdate_stats_kernel", "accumulate_sweep_stats"),
               ("modelupdate_resample_kernel", "resample_model"))
    for e in prof.events():
        own = [k for k in e.kernels if not any(kind in k.name for kind, _ in by_name)]
        us = sum(k.duration for k in own)
        if e.device_type != torch.autograd.DeviceType.CPU or not us:
            continue
        where, node = "(outside the stages)", e.cpu_parent
        while node is not None:
            if node.name.startswith("stage:"):
                where = node.name[len("stage:"):]
                break
            node = node.cpu_parent
        by[where] = by.get(where, 0.0) + us
        for k in own if where in names else ():
            names[where][k.name] = names[where].get(k.name, 0) + 1
    for k in device_kernels(prof):  # launched through ctypes: no CPU operator owns them
        for kind, stage in by_name:
            if kind in k.name:
                by[stage] = by.get(stage, 0.0) + k.time_range.elapsed_us()
                if stage in names:
                    names[stage][k.name] = names[stage].get(k.name, 0) + 1
    missing = sum(k.time_range.elapsed_us() for k in device_kernels(prof)) - sum(by.values())
    if missing > 0:  # kernels that no CPU event of the trace lists as its own
        by["(credited to no CPU event)"] = missing
    return {"stages": [(w, round(us / iters / 1e3, 5)) for w, us in sorted(by.items(), key=lambda kv: -kv[1])],
            "total_ms": sum(by.values()) / iters / 1e3,
            "model_stages": {stage: {n: c / iters for n, c in sorted(kern.items())}
                             for stage, kern in names.items()}}


def phase_profile(main_eng, sharded_eng, sharded_eager, tracks: dict,
                  sharded_tracks: dict | None = None) -> dict:
    """torch.profiler over F 64 4: CUDA kernels and device ms per settled
    sweep of the [main] engine with the debug bitmask off and on, and of the
    [sharded] engine; launch calls, kernels and device ms per sweep of the
    graphed and the eager [main] and [sharded] engines and of the graphed
    [states9], [states27], [states64] and [states81] engines (``tracks``:
    phase -> kind -> engine), whose FB scan kernels must be the team, the
    wide, the tiled-product instances and the tiled instances with j
    streamed with the grouped suffix, and the eager [states9], [states27],
    [states64] and [states81] sweeps' device ms by stage. It runs last: once
    the profiler has traced the card, every later launch of the process pays
    more host time, which would lower any rate measured after it."""
    old = os.environ.get("HAMMLET_DEBUG")
    res = {}
    try:
        for flag in ("0", "1"):
            os.environ["HAMMLET_DEBUG"] = flag
            res[flag] = profile_f(main_eng)
        os.environ["HAMMLET_DEBUG"] = "0"
        res["sharded"] = profile_f(sharded_eng)
    finally:
        if old is None:
            del os.environ["HAMMLET_DEBUG"]
        else:
            os.environ["HAMMLET_DEBUG"] = old
    check(res["0"][0] > 0 and res["sharded"][0] > 0, "the profiler saw no CUDA kernel")
    check(res["1"][0] > res["0"][0], "HAMMLET_DEBUG=1 launched no kernel more than debug off")
    res["graph"] = profile_launches(main_eng)
    calls = res["graph"]["launch_calls"]
    check(calls.get("cudaGraphLaunch", 0) >= 1, f"the graphed sweep launched no graph: {calls}")
    check(sum(calls.values()) <= 8, f"the graphed sweep made {calls} launch calls per sweep")
    res["sharded_graph"] = profile_launches(sharded_eng)
    calls = res["sharded_graph"]["launch_calls"]
    check(calls.get("cudaGraphLaunch", 0) >= 1 and sum(calls.values()) <= 8 + 2 * P_SHARDED,
          f"the graphed P = {P_SHARDED} sweep made {calls} launch calls per sweep")
    for tag in ("graph", "sharded_graph"):
        names = " ".join(res[tag]["fbscan"])
        check("fbscan_prefix" in names and "fbscan_suffix" in names,
              f"the {tag} sweep ran no FB prefix or suffix scan kernel: {res[tag]['fbscan']}")
        names = " ".join(res[tag]["model"])
        check("modelupdate_stats_kernel" in names and "modelupdate_resample_kernel" in names,
              f"the {tag} sweep ran no sweep statistics or resample kernel: {res[tag]['model']}")
    res["sharded_eager"] = profile_launches(sharded_eager)
    for tag, kinds in (("states9", ("fbscan_prefix_team", "fbscan_suffix_one")),
                       ("states27", FB_WIDE + ("fbscan_suffix_one",)),
                       ("states64", FB_DEEP + ("fbscan_suffix_one",)),
                       ("states81", FB_TILED + FB_SUFFIX_GROUPED)):
        res[tag] = profile_launches(tracks[tag]["graph"])
        names = " ".join(res[tag]["fbscan"])
        check(all(kind in names for kind in kinds),
              f"[{tag}] the graphed sweep's FB scan kernels were {res[tag]['fbscan']}")
        names = " ".join(res[tag]["model"])
        check("modelupdate_stats_kernel" in names and "modelupdate_resample_kernel" in names,
              f"[{tag}] the graphed sweep ran no model-update kernel: {res[tag]['model']}")
        res[tag + "_split"] = device_split_by_stage(tracks[tag]["eager"])
    for K, eng in (sharded_tracks or {}).items():  # [sharded_tracks] (f), checked by the caller
        res[f"sharded{K}"] = profile_launches(eng)
    eager_engine(main_eng)  # its chunks run the eager gibbs_phase from here on
    res["eager"] = profile_launches(main_eng)
    res["split"] = device_split_by_stage(main_eng)
    # the model update's stages launch its kernels and the resample's draws, and
    # nothing of the one-hot matmuls and elementwise Gamma sampler they replace
    for stage, allowed in (("accumulate_sweep_stats", ("modelupdate_stats_kernel",)),
                           ("resample_model", ("modelupdate_resample_kernel", "distribution"))):
        names = res["split"]["model_stages"].get(stage, {})
        check(bool(names) and all(any(a in n for a in allowed) for n in names),
              f"the eager sweep's {stage} stage launched {names}")
    return res


def check_streams(prefix: str, suffix: str, T: int, K: int, n_params: int, dim: int,
                  n_rec: int, truth: np.ndarray, where: str,
                  map_min: float | None = MAP_AGREEMENT_MIN) -> dict:
    """The CLI's seven output streams ``prefix``<stream>``suffix`` of a run
    on T positions with K = n_params^dim states that recorded ``n_rec``
    sweeps: one line per recorded sweep in every per-sweep stream; blocks
    and sequences cover T; compression is T / #blocks; 2 P fields per
    parameters line; the mapping is the combinations mapping; sequences
    never repeat a state and their boundaries lie on marginals boundaries;
    each segments line counts the union of the boundaries recorded so far,
    + 1, and (K + 1) times that; marginal rows cover T in at most K columns
    and sum to n_rec; MAP agreement >= ``map_min`` unless that is None.
    Returns the agreement, the last segments count and the marginal rows."""
    from hammlet_tpu_torch.models.mapping import combinations_mapping

    lines = {s: open(f"{prefix}{s}{suffix}").read().splitlines() for s in ALL_STREAMS}
    for s in PER_SWEEP_STREAMS:
        check(len(lines[s]) == n_rec, f"{where} {s}: {len(lines[s])} lines, not {n_rec}")
    check(lines["mapping"] == ["\t".join(map(str, row))
                               for row in combinations_mapping(dim, n_params)],
          f"{where} mapping stream")
    check(all(len(x.split("\t")) == 2 * n_params for x in lines["parameters"]),
          f"{where} parameters lines of other than {2 * n_params} fields")
    for blk, comp in zip(lines["blocks"], lines["compression"]):
        sizes = np.array(blk.split("\t"), dtype=np.int64)
        check(int(sizes.sum()) == T and bool((sizes > 0).all()), f"{where} blocks line")
        check(comp == f"{T / len(sizes):.6g}", f"{where} compression {comp} != T/{len(sizes)}")
    rows = np.array([r.split("\t") for r in lines["marginals"]], dtype=np.int64)
    sizes, counts = rows[:, 0], rows[:, 1:]
    check(int(sizes.sum()) == T and counts.shape[1] <= K, f"{where} marginal rows do not cover T "
          f"in at most {K} columns")
    check(bool((counts.sum(axis=1) == n_rec).all()), f"{where} marginal row sums != {n_rec}")
    marg_bound = np.zeros(T + 1, dtype=bool)
    marg_bound[np.cumsum(sizes)] = True
    union = np.zeros(T + 1, dtype=bool)
    nseg = 1
    for seq, seg in zip(lines["sequences"], lines["segments"]):
        toks = np.array(seq.replace(":", "\t").split("\t"), dtype=np.int64).reshape(-1, 2)
        check(int(toks[:, 0].sum()) == T, f"{where} sequences line does not cover T")
        check(bool((toks[:, 1] < K).all()), f"{where} sequences: a state >= {K}")
        check(bool((toks[1:, 1] != toks[:-1, 1]).all()), f"{where} sequences: equal adjacent states")
        bounds = np.cumsum(toks[:-1, 0])
        check(bool(marg_bound[bounds].all()), f"{where} sequence boundary not on a marginals boundary")
        union[bounds] = True
        nseg, internal = map(int, seg.split("\t"))
        check(nseg == int(union.sum()) + 1 and internal == (K + 1) * nseg,
              f"{where} segments {nseg} {internal} != recorded boundaries {int(union.sum())} + 1, "
              f"times {K + 1}")
    agreement = map_agreement(sizes, counts, truth)
    check(map_min is None or agreement >= map_min, f"{where} MAP agreement {agreement:.4f}")
    return {"map_agreement": agreement, "segments": nseg, "rows": len(sizes)}


def phase_cli(main_rate: float) -> dict:
    """The CLI with every output stream at the main path's size."""
    data, truth = synth(T_MAIN, SEED)
    engines = []
    make_engine = cli.make_engine

    def spy(*args, **kwargs):  # keep the engine and time its setup
        t0 = time.perf_counter()
        eng = make_engine(*args, **kwargs)
        torch.cuda.synchronize()
        engines.append((eng, time.perf_counter() - t0))
        return eng

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.txt")
        with open(path, "w") as fh:  # shortest round-trip text of each float32
            fh.write("\n".join(map(repr, data.astype(np.float64).tolist())) + "\n")
        argv = ["-f", path, "-s", "3", "-a", "-R", str(SEED), "-i", *SCHEME.split(),
                "-O", *ALL_STREAMS, "-w"]
        cli.make_engine = spy
        reset_counts()
        try:
            rc = cli.main(argv)
        finally:
            cli.make_engine = make_engine
        launches = read_counts()
        check(rc == 0 and len(engines) == 1, f"cli.main returned {rc}")
        eng, setup_s = engines[0]
        streams = check_streams(os.path.join(tmp, "smoke-"), ".txt", T_MAIN, 3, 3, 1, N_RECORDED,
                                truth, "[cli]")
    check(eng.device.type == "cuda", f"CLI engine ran on {eng.device}")
    check_graphed(eng, "[cli]")
    for name, n in launches.items():
        check(n >= 1, f"the CLI never launched {name}")
    check(streams["segments"] == streams["rows"] == int(eng.buffers.n_boundaries) + 1,
          "segments vs marginals rows")
    f_sweeps = sum(n for m, n, _ in eng.phase_log if m == "F")
    f_secs = sum(t for m, _, t in eng.phase_log if m == "F")
    return {
        "launches": launches,
        "setup_s": setup_s,
        "f_sweeps_per_s": f_sweeps / f_secs,
        "ratio": f_sweeps / f_secs / main_rate,
        "map_agreement": streams["map_agreement"],
        "native": native.available(),
    }


def phase_resume() -> None:
    """Checkpoint -> restore -> continue is bitwise the uninterrupted run."""
    data = synth(T_RESUME, SEED + 1)[0]

    def build():
        return runner.make_engine(data, nr_params=3, seed=SEED + 1)

    whole, eager = build(), eager_engine(build())
    for eng in (whole, eager):
        eng.run("M", 32, 0)
        eng.run("F", 64, 4)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resume.npz")
        cut = build()
        cut.run("M", 32, 0)
        checkpoint.save_checkpoint(cut, path)
        resumed = build()
        resumed.run("M", 2, 0)  # graphs captured on its buffers before the restore
        checkpoint.restore_checkpoint(resumed, path)
    resumed.run("F", 64, 4)
    check(resumed.device.type == "cuda", f"resume ran on {resumed.device}")
    for eng, tag in ((whole, "uninterrupted"), (cut, "cut"), (resumed, "resumed")):
        check_graphed(eng, f"[resume] {tag} run")
    for other, tag in ((whole, "uninterrupted"), (eager, "uninterrupted eager")):
        check(torch.equal(other.buffers.counts, resumed.buffers.counts),
              f"resumed marginal counts differ from the {tag} run")
        check(torch.equal(other.model.theta_mean, resumed.model.theta_mean),
              f"resumed emission means differ from the {tag} run")
    check(int(resumed.buffers.n_records) == 16, "resumed run recorded != 16 sweeps")


def phase_debug(data: np.ndarray | None = None, where: str = "[debug]") -> dict:
    """The per-sweep invariant bitmask on the card: with HAMMLET_DEBUG=1 a
    healthy F chunk raises nothing and a NaN emission mean raises
    FloatingPointError ("emission mean"); by default at K = 3 on T_RESUME
    positions, else on ``data`` (T, tracks) at K = 3^tracks.
    Returns the engine's K and the seconds."""
    old = os.environ.get("HAMMLET_DEBUG")
    os.environ["HAMMLET_DEBUG"] = "1"
    t0 = time.perf_counter()
    if data is None:
        data = synth(T_RESUME, SEED + 2)[0]
    try:
        eng = runner.make_engine(data, nr_params=3,
                                 nr_data_dim=1 if data.ndim == 1 else data.shape[1], seed=SEED + 2)
        check(eng.device.type == "cuda", f"{where} engine on {eng.device}")
        eng.run("M", 16, 0)
        eng.run("F", 16, 2)  # a healthy chunk: raises on any error bit
        mean = eng.model.theta_mean.clone()
        mean[1] = float("nan")
        eng.model = eng.model._replace(theta_mean=mean)
        try:
            eng.run("F", 4, 0)
        except FloatingPointError as exc:
            check("emission mean" in str(exc), f"{where} wrong error: {exc}")
        else:
            raise SmokeFailure(f"{where} a NaN emission mean did not raise")
    finally:
        if old is None:
            del os.environ["HAMMLET_DEBUG"]
        else:
            os.environ["HAMMLET_DEBUG"] = old
    return {"K": eng.spec.nr_states, "seconds": time.perf_counter() - t0}


def sharded_run(data: np.ndarray, tmp: str, tag: str, mesh=None, eager: bool = False) -> tuple:
    """make_sharded_engine -> run_scheme -> finalize with marginals,
    parameters and compression, the chunks graphed or (``eager``) through
    the plain sharded_phase; returns (engine, setup s, stream bytes)."""
    prefix = os.path.join(tmp, tag + "-")
    rec = Records(T_MAIN, prefix, ".csv", 3,
                  outputs={"marginals", "parameters", "compression"}, overwrite=True)
    t0 = time.perf_counter()
    eng = sharded.make_sharded_engine(
        data, mesh=mesh, n_devices=P_SHARDED, nr_params=3, seed=SEED, records=rec,
        device="cuda",
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if eager:
        eager_sharded_engine(eng)
    eng.run_scheme(SCHEME.split())
    eng.finalize()
    torch.cuda.synchronize()
    out = {s: open(prefix + s + ".csv", "rb").read()
           for s in ("marginals", "parameters", "compression")}
    return eng, setup_s, out


def phase_sharded(main_eng, pairs: int = SHARDED_PAIRS) -> dict:
    """The position-sharded engine, P = 4 shards on the one card."""
    data, truth = synth(T_MAIN, SEED)
    res: dict = {}

    # (a) sharded host ingest vs the kernel-driven device ingest
    mesh = position_mesh(P_SHARDED, "cuda")
    T_local, cell_bits = sharded._choose_layout(T_MAIN, P_SHARDED)
    t0 = time.perf_counter()
    ing = sharded_ingest(mesh, data, T_local=T_local, cell_bits=cell_bits)
    torch.cuda.synchronize()
    res["ingest_s"] = time.perf_counter() - t0
    weights = torch.empty_like(ing.negw).scatter_(1, ing.rank, -ing.negw).reshape(-1)[:T_MAIN]
    before = read_counts()
    ref = runner.ingest_device(data, device="cuda")
    check(all(read_counts()[k] == before[k] + 1 for k in MAXLET_NAMES),
          "ingest_device did not launch each maxlet kernel once")
    check(bits_equal(weights, ref.weights), "sharded ingest weights != ingest_device's (kernel)")
    del ing, ref, weights

    # the main sharded run (c), measured
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wavelet_cuda.maxlet_transform_cuda.launches = 0
        eng, res["setup_s"], plain = sharded_run(data, tmp, "plain")
        res["launches"] = wavelet_cuda.maxlet_transform_cuda.launches
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
        sizes, counts = read_marginals(os.path.join(tmp, "plain-marginals.csv"))
        # (h) the same run with its chunks through the eager sharded_phase
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eager, _, eager_out = sharded_run(data, tmp, "eager", eager=True)
        res["eager_peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
    check(eng.device.type == "cuda", f"sharded engine ran on {eng.device}")
    check_graphed(eng, "[sharded]")
    pg = eng.phase_graphs
    check(pg.graphs == pg.captures, f"[sharded] {pg.graphs} graphs for {pg.captures} sweep kinds: "
          "without a process group a sweep is one graph")
    check(eager.phase_graphs.replays == 0, "[sharded] the eager engine replayed graphs")
    for s_ in plain:
        check(eager_out[s_] == plain[s_], f"[sharded] {s_}: the graphed engine's bytes differ from "
              "the eager sharded_phase engine's")
    res["captures"] = [pg.captures, pg.graphs, round(pg.capture_seconds, 4)]
    res["eager_phases"] = [(m, n, round(t, 4)) for m, n, t in eager.phase_log]
    check(int(sizes.sum()) == T_MAIN, "sharded marginal rows do not cover T")
    check(bool((counts.sum(axis=1) == N_RECORDED).all()), "sharded marginal row sums != 128")
    res["map_agreement"] = map_agreement(sizes, counts, truth)
    check(res["map_agreement"] >= MAP_AGREEMENT_MIN, f"sharded MAP agreement {res['map_agreement']:.4f}")
    f_sweeps = sum(n for m, n, _ in eng.phase_log if m == "F")
    res["f_sweeps_per_s"] = f_sweeps / sum(t for m, _, t in eng.phase_log if m == "F")
    res["cap_local"] = eng.cap_local
    res["last_n_blocks"] = eng.last_n_blocks

    # (d) a whole sharded F chunk with no host sync (at twice the settled
    # capacity, so that no sweep overflows and every recording one records)
    settled_cap = eng.cap_local
    eng.cap_local = min(eng.T_local, 2 * settled_cap)
    candpos, candrank = eng._shard_candidates()
    eng.cap_local = settled_cap
    buffers = eng.buffers.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sharded.sharded_phase(
            eng.mesh, eng.seed, 10**6, eng.model, eng.priors, eng.negw, candpos, candrank,
            eng.r_t, eng.q2_hi, eng.q2_lo, buffers, None, method="F", T=eng.T,
            T_local=eng.T_local, cell_bits=eng.cell_bits, mapping=eng._mapping,
            nr_params=3, use_self_transitions=True, n_iters=8, thinning=2,
            want_blocks=True,
        )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(int(out[3][0]) <= candrank.shape[1] and int(buffers.n_rec) == N_RECORDED + 4,
          "the sync-free sharded chunk did not record its 4 sweeps")
    del out, buffers

    # settled rates of P = 1 ([main]'s engine) and of P = 4 graphed and
    # eager in alternating pairs, P = 1 first and last
    rates: dict = {"one": [], "sharded": [], "eager": []}
    engines = {"one": main_eng, "sharded": eng, "eager": eager}
    res["settled_order"] = ("one",) + alternating("sharded", "eager", pairs) + ("one",)
    with tempfile.TemporaryDirectory() as tmp:
        for turn, tag in enumerate(res["settled_order"]):
            e = engines[tag]
            e.records = Records(T_MAIN, os.path.join(tmp, f"{tag}{turn}-"), ".csv", 3,
                                outputs={"marginals", "parameters", "compression"},
                                overwrite=True)
            e.run("F", 512, 4)
            e.records.close()
            rates[tag].append(512 / e.phase_log[-1][2])
    eng.records = eager.records = None
    # the sweep's own matrices and maps, statistics inputs and resample inputs
    with ScanInputs() as scans, ModelInputs() as models:
        eager.run("F", 4, 4)
    res["scans"], res["models"] = scans, models
    res["settled"] = rates
    res["settled_ratio"] = float(np.median(rates["sharded"]) / np.median(rates["one"]))
    res["graph_ratio"] = float(np.median(rates["sharded"]) / np.median(rates["eager"]))

    # (b) one sweep under one fixed model: the same partition as P = 1
    with tempfile.TemporaryDirectory() as tmp:
        model = main_eng.model
        eng.model = model._replace(**{k: v.clone() for k, v in model._asdict().items()})
        for tag, e in (("one", main_eng), ("sharded", eng)):
            e.records = Records(T_MAIN, os.path.join(tmp, tag + "-"), ".csv", 3,
                                outputs={"blocks"}, overwrite=True)
        main_eng.run("F", 1, 1)
        eng._one_sweep("F", do_record=True)
        for e in (main_eng, eng):
            e.records.close()
        blocks = [open(os.path.join(tmp, t + "-blocks.csv")).read() for t in ("one", "sharded")]
    check(blocks[0] == blocks[1] and blocks[0].count("\t") > 100,
          "sharded block partition != single-device partition")
    res["n_blocks"] = blocks[0].count("\t") + 1
    res["engine"], res["eager_engine"] = eng, eager  # profiled last (phase_profile)

    # (e) the same run in a world-size-1 NCCL process group
    env = {"HAMMLET_NUM_PROCESSES": "1", "HAMMLET_PROCESS_ID": "0",
           "HAMMLET_COORDINATOR": f"localhost:{free_port()}"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed.initialize_from_env()
        check(torch.distributed.get_backend() == "nccl", "the process group is not NCCL")
        with tempfile.TemporaryDirectory() as tmp:
            eng_g, _, grouped = sharded_run(data, tmp, "nccl", mesh=position_mesh(P_SHARDED))
        check(eng_g.mesh.group is not None, "the NCCL run had no process group")
        # every collective goes through NCCL: a sweep kind is several graphs
        pg = eng_g.phase_graphs
        check_graphed(eng_g, "[sharded] (e)")
        check(pg.graphs >= 4 * pg.captures, f"[sharded] (e) {pg.graphs} graphs for {pg.captures} "
              "sweep kinds in an NCCL group: the collectives are not between the graphs")
        res["nccl_captures"] = [pg.captures, pg.graphs, round(pg.capture_seconds, 4)]
        del eng_g
    finally:
        distributed.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for s in plain:
        check(grouped[s] == plain[s], f"NCCL world-size-1 run: {s} differs from the run without a group")

    # (f) P = 4 checkpoint resume at T_RESUME
    small = synth(T_RESUME, SEED + 1)[0]

    def build():
        return sharded.make_sharded_engine(small, n_devices=P_SHARDED, nr_params=3,
                                           seed=SEED + 1, device="cuda")

    whole = build()
    whole.run("M", 32, 0)
    whole.run("F", 64, 4)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resume.npz")
        cut = build()
        cut.run("M", 32, 0)
        checkpoint.save_sharded_checkpoint(cut, path)
        resumed = build()
        checkpoint.restore_sharded_checkpoint(resumed, path)
    resumed.run("F", 64, 4)
    check_graphed(resumed, "[sharded] (f)")
    for name in ("counts", "everb", "n_rec", "n_bound"):
        check(torch.equal(getattr(whole.buffers, name), getattr(resumed.buffers, name)),
              f"sharded resume: {name} differs from the uninterrupted run")
    check(all(torch.equal(a, b) for a, b in zip(whole.model, resumed.model)),
          "sharded resume: the model differs from the uninterrupted run")
    check(int(resumed.buffers.n_rec) == 16, "sharded resume recorded != 16 sweeps")

    # (g) -D 4 with one card visible stays in one process
    cards = distributed.card_count()
    check(cards == torch.cuda.device_count(),
          f"NVML counts {cards} cards, torch {torch.cuda.device_count()}")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "d.csv")
        np.savetxt(path, small, fmt="%.6f")
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "bin", "hammlet-torch"), "-f", path, "-a", "-R", "1",
             "-D", str(P_SHARDED), "-i", "M", "8", "0", "F", "8", "2", "-w", "-v"],
            env={**env, "CUDA_VISIBLE_DEVICES": "0"}, capture_output=True, text=True, timeout=300,
        )
        check(proc.returncode == 0 and os.path.exists(os.path.join(tmp, "d-marginals.csv")),
              f"-D {P_SHARDED} on one card failed: {proc.stderr[-2000:]}")
    check("Device: cuda:0" in proc.stdout and "Cards:" not in proc.stdout
          and "Processes:" not in proc.stdout,
          f"-D {P_SHARDED} with one card visible left its process: {proc.stdout[-2000:]}")
    res["cards"] = cards
    return res


def phase_chains(tmp: str, devices: list[torch.device] | None = None,
                 order: tuple = CHAIN_ORDER) -> dict:
    """One chromosome of T_CHAIN positions per device of ``devices`` (two
    on cuda:0 by default) through ``cli.main -M``: the threaded path (one
    chain per device of ``_chain_devices``), taking turns at phases
    ("threads", the CLI's way) or not ("free"), against the sequential path
    (the first device alone), in the turns of ``order``, byte for byte;
    every chain runs device ingest, so each maxlet kernel launches once per
    chain, and every chain's engine replays CUDA graphs. First each kernel
    is held against its plain version on each chain's data as the CLI reads
    it (check_kernels). The counts are those of the first threaded run."""
    devices = devices or [torch.device("cuda", 0)] * 2
    device, n = devices[0], len(devices)
    files = []
    worst = {"chunk": 0.0, "cross": 0.0, "transform": 0.0}
    for i in range(n):
        path = os.path.join(tmp, f"chr{i + 1}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(map(repr, synth(T_CHAIN, SEED + 10 + i)[0].astype(np.float64).tolist())))
            fh.write("\n")
        files.append(path)
        x_cpu = torch.from_numpy(np.ascontiguousarray(read_values([path], 1)))
        check_kernels(x_cpu.to(devices[i]), x_cpu, worst)
    torch.cuda.empty_cache()
    streams = ["marginals", "parameters", "compression"]
    chain_devices = cli._chain_devices
    seen: list = []
    engines: list = []
    run_chain, make_engine = cli._run_chain, cli.make_engine
    free = [False]

    def spy(sub, device, turn):
        seen.append((threading.get_ident(), str(device)))
        return run_chain(sub, device, None if free[0] else turn)

    res: dict = {"threads_s": [], "free_s": [], "sequential_s": [], "worst": worst}
    outputs = []
    try:
        cli._run_chain = spy
        cli.make_engine = lambda *a, **k: engines.append(make_engine(*a, **k)) or engines[-1]
        for turn, tag in enumerate(order):
            free[0] = tag == "free"
            chain_devs = devices if tag != "sequential" else [device]
            cli._chain_devices = lambda chain_devs=chain_devs: chain_devs
            prefix = os.path.join(tmp, f"{tag}{turn}-")
            argv = ["-M", "-f", *files, "-o", prefix, ".csv", "-s", "3", "-a", "-R", str(SEED),
                    "-i", *CHAIN_SCHEME.split(), "-O", *streams, "-w"]
            seen.clear()
            for d in set(devices):
                synchronize(d)
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            for d in set(devices):
                synchronize(d)
            res[tag + "_s"].append(time.perf_counter() - t0)
            counts = read_counts()
            check(rc == 0, f"-M ({tag}) returned {rc}")
            for name in MAXLET_NAMES:
                check(counts[name] == n, f"-M ({tag}) launched {name} {counts[name]} times, "
                      "not once per chain")
            for name in SWEEP_NAMES:
                check(counts[name] >= n, f"-M ({tag}) launched {name} {counts[name]} times, "
                      f"fewer than the {n} chains")
            if tag != "sequential":
                check(len({t for t, _ in seen}) == n
                      and sorted(d for _, d in seen) == sorted(map(str, devices)),
                      f"threaded -M chains ran as {seen}")
            if tag == "threads":
                res.setdefault("threads_launches", counts)
                res.setdefault("prefix", prefix + "chr1-")
            elif tag == "sequential":
                check(not seen, f"sequential -M ran chains in threads: {seen}")
            check(len(engines) == n, f"-M ({tag}) built {len(engines)} engines, not {n}")
            for eng in engines:
                check_graphed(eng, f"-M ({tag})")
            engines.clear()
            outputs.append({(i, s): open(f"{prefix}chr{i + 1}-{s}.csv", "rb").read()
                            for i in range(n) for s in streams})
    finally:
        cli._chain_devices = chain_devices
        cli._run_chain = run_chain
        cli.make_engine = make_engine
    for turn, out in enumerate(outputs[1:], 1):
        for key, b in out.items():
            check(b == outputs[0][key], f"-M turn {turn} ({order[turn]}) chain {key} "
                  "differs from the first run")
    for i in range(n):
        sizes, counts = read_marginals(f"{res['prefix'][:-len('chr1-')]}chr{i + 1}-marginals.csv")
        check(int(sizes.sum()) == T_CHAIN and bool((counts.sum(axis=1) == CHAIN_RECORDED).all()),
              f"chain {i + 1}: marginal rows do not cover T or sum to {CHAIN_RECORDED}")
    res["ratio"] = float(np.median(res["sequential_s"]) / np.median(res["threads_s"]))
    if res["free_s"]:
        res["free_ratio"] = float(np.median(res["sequential_s"]) / np.median(res["free_s"]))
    return res


def phase_tools(prefix: str) -> dict:
    """bin/hammlet-torch-max-segmentation and -sort-states on a [chains]
    chain's outputs, each in a subprocess (no JAX on this machine); the
    segmentation covers T and equals the tool function's output in this
    process."""
    from hammlet_tpu_torch.tools import max_segmentation

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for tool, args in (("max-segmentation", ["-i", prefix + "marginals.csv"]),
                       ("sort-states", [prefix + "parameters.csv"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(here, "bin", f"hammlet-torch-{tool}"), *args],
                              capture_output=True, text=True, timeout=300, cwd=here)
        check(proc.returncode == 0, f"hammlet-torch-{tool} failed: {proc.stderr[-2000:]}")
        out[tool] = (proc.stdout, time.perf_counter() - t0)
    seg = np.array([line.split("\t") for line in out["max-segmentation"][0].splitlines()], dtype=np.int64)
    check(int(seg[:, 0].sum()) == T_CHAIN and set(seg[:, 1].tolist()) <= {0, 1, 2},
          "max-segmentation rows do not cover T in states 0-2")
    with open(prefix + "marginals.csv") as fh:
        inproc = io.StringIO()
        max_segmentation.run(fh, inproc)
    check(inproc.getvalue() == out["max-segmentation"][0], "max-segmentation subprocess != in-process")
    lines = out["sort-states"][0].splitlines()
    check(lines[0] == "#state\tmean" and sorted(int(x.split("\t")[0]) for x in lines[1:]) == [0, 1, 2],
          f"sort-states printed {lines}")
    return {"segments": len(seg), "means": lines[1:],
            "seconds": {t: round(v[1], 3) for t, v in out.items()}}


# [cli_tracks]: the CLI's user surface on multi-track data, the data of [states9]-[states81] at
# each configuration's CLI T (CLI_TRACKS_T positions per track): (a) the default scheme's ops in
# order (M 500 0 S P F 200 0 F 300 3, its sweeps cut) with every stream, graphed against eager at
# CLI_TRACKS_EAGER; (b) -C killed after its first checkpoint and resumed at CLI_TRACKS_RESUME;
# (c) -M over two inputs of CLI_TRACKS_CHAIN_T positions x 3 tracks (device ingest), threads
# against one after another; (d) HAMMLET_DEBUG=1 at K = 81; (e) F phases right after a prior
# draw, with and without a capacity ceiling (CLI_TRACKS_PRIOR_RUNS)
CLI_TRACKS_T = 400_000
CLI_TRACKS_SCHEME = "M 32 0 S P F 32 0 F 128 4"
# the engine seed of every [cli_tracks] run, chosen as the first at which CLI_TRACKS_SCHEME's chain
# reached MAP_AGREEMENT_MIN at every K on the card (cli_map_survey.py; PERF.md §6). (a)'s MAP gate
# thus holds one chain: at K = 64 the chains of the default scheme's ops stay in a local mode at
# most seeds, the JAX package's on the CPU too (ROADMAP §3)
CLI_TRACKS_SEED = 1
CLI_TRACKS_EAGER = (27, 81)
CLI_TRACKS_RESUME = (27, 81)
CLI_TRACKS_CKPT_EVERY = 32  # (b): the first checkpoint ends the M phase
CLI_TRACKS_CHAIN_T = 1_000_000  # (c): 3M values per input, so each chain takes device ingest
# (e): HAMMLET_MAX_CAPACITY at K = 64 and 81. The first F chunk after a prior draw takes ~108
# KB a block at K = 81 and ~67 KB at K = 64 on the H100 (PERF.md §6: 41,384 and 25,450 MiB at
# capacity 400,000, fbscan_probes.py prior_peak); 2^17 blocks take ~14 GB at K = 81, a sixth
# of the card's 80 GB, which leaves room for the process's other engines and a second -M chain
CLI_TRACKS_CEILING = 131_072
# (e): (K, scheme, ceiling or None). They run in this process, which holds the engines of earlier
# phases: K = 81 with no ceiling, which alone needs ~41 GB (fbscan_probes.py prior_peak), may
# not fit beside them
CLI_TRACKS_PRIOR_RUNS = ((9, "F 16 0 F 64 4", None), (27, "F 16 0 F 64 4", None),
                         (64, "F 16 0 F 64 4", CLI_TRACKS_CEILING),
                         (81, "F 16 0 F 64 4", CLI_TRACKS_CEILING),
                         (81, "M 16 0 P F 16 0 F 64 4", CLI_TRACKS_CEILING),
                         (81, "F 16 0 F 64 4", None))
# (b)'s child: the CLI, killed (os._exit: the streams' buffers are lost) right after its first
# checkpoint, which it times
CLI_TRACKS_KILLED = """
import json, os, sys, time
from hammlet_tpu_torch import cli, runner
real = runner.save_checkpoint
def save(engine, path):
    t0 = time.perf_counter()
    real(engine, path)
    print(json.dumps({"sweeps": engine.sweeps_completed, "seconds": time.perf_counter() - t0,
                      "bytes": os.path.getsize(path)}), flush=True)
    os._exit(9)
runner.save_checkpoint = save
sys.exit(cli.main(sys.argv[1:]))
"""


def cli_tracks_cases() -> dict:
    """K -> (tag, data function, -s arguments) of the configurations
    [cli_tracks] runs: those of [states9], [states27], [states64] and
    [states81]."""
    return {K: (tag, steps, states) for tag, steps, K, states, *_ in sharded_tracks_cases()}


def log_chunks(eng, log: list) -> None:
    """Append a dict per chunk ``eng`` runs (an overflow's replay included):
    method, sweeps, capacity, the ceiling, the most blocks a sweep of it
    needed, whether it ran truncated (more blocks than the capacity at the
    ceiling: accepted as it is), seconds, and the peak device memory
    allocated during it above what was allocated when it began (the
    process's other engines and this engine's own state excluded) and the
    peak reserved by the process; a chunk that raised is logged with its
    error."""
    real = eng._run_chunk

    def run_chunk(counter, method, n, *rest):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        row = {"method": method, "n": n, "record": bool(rest[1]), "capacity": eng.capacity,
               "ceiling": eng.max_capacity}
        t0 = time.perf_counter()
        try:
            out = real(counter, method, n, *rest)
            torch.cuda.synchronize()
        except BaseException as exc:
            row.update(error=type(exc).__name__, peak=torch.cuda.max_memory_allocated() - base,
                       reserved=torch.cuda.max_memory_reserved())
            log.append(row)
            raise
        row.update(max_nb=int(out[0][0]), seconds=time.perf_counter() - t0,
                   peak=torch.cuda.max_memory_allocated() - base,
                   reserved=torch.cuda.max_memory_reserved())
        row["truncated"] = row["max_nb"] > eng.capacity >= eng.max_capacity
        log.append(row)
        return out

    eng._run_chunk = run_chunk


def run_cli(argv: list[str], eager: bool = False, log: list | None = None) -> dict:
    """cli.main(argv) in this process, its engines kept (made eager, and
    their chunks logged into ``log``, if asked): exit code, engines,
    standard error, seconds."""
    engines: list = []
    make_engine = cli.make_engine

    def spy(*args, **kwargs):
        eng = make_engine(*args, **kwargs)
        if eager:
            eager_engine(eng)
        if log is not None:
            log_chunks(eng, log)
        engines.append(eng)
        return eng

    err = io.StringIO()
    cli.make_engine = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        cli.make_engine = make_engine
    return {"rc": rc, "engines": engines, "stderr": err.getvalue(),
            "seconds": time.perf_counter() - t0}


def cli_tracks_argv(path: str, states: list[str], prefix: str, scheme: str) -> list[str]:
    return ["-f", path, "-s", *states, "-a", "-R", str(CLI_TRACKS_SEED), "-i", *scheme.split(),
            "-O", *ALL_STREAMS, "-o", prefix, ".csv", "-w"]


def stream_bytes(prefix: str) -> dict:
    return {s: open(f"{prefix}{s}.csv", "rb").read() for s in ALL_STREAMS}


def phase_summary(log: list) -> list:
    """(method, recording or not, sweeps, capacity of its first chunk, peak
    MiB allocated, peak MiB reserved, seconds) of each run of chunks of one
    method that all record or all do not, in a chunk log."""
    out: list = []
    for row in log:
        if out and (out[-1]["method"], out[-1]["record"]) == (row["method"], row["record"]):
            last = out[-1]
            last["n"] += row["n"]
            last["peak_mib"] = max(last["peak_mib"], row["peak"] / 2**20)
            last["reserved_mib"] = max(last["reserved_mib"], row.get("reserved", 0) / 2**20)
            last["seconds"] += row.get("seconds", 0.0)
        else:
            out.append({"method": row["method"], "record": row["record"], "n": row["n"],
                        "capacity": row["capacity"],
                        "peak_mib": row["peak"] / 2**20,
                        "reserved_mib": row.get("reserved", 0) / 2**20,
                        "seconds": row.get("seconds", 0.0)})
    return [(p["method"] + (" rec" if p["record"] else ""), p["n"], p["capacity"],
             round(p["peak_mib"], 1),
             round(p["reserved_mib"], 1), round(p["seconds"], 3)) for p in out]


def cli_tracks_default(tmp: str, K: int, path: str, truth: np.ndarray, states: list[str]) -> dict:
    """(a) at K: bin/hammlet-torch's CLI (cli.main) with CLI_TRACKS_SCHEME and
    every stream on the card, the streams checked at K columns
    (check_streams), every sweep a graph replay; at CLI_TRACKS_EAGER the
    same argv through an engine whose chunks run the eager gibbs_phase
    writes the same bytes. Returns seconds, phases (capacity, peaks), the
    drain's seconds per chunk, MAP agreement."""
    where = f"[cli_tracks] (a) K={K}"
    n_params, dim = int(states[1]), int(states[2])
    log: list = []
    run = run_cli(cli_tracks_argv(path, states, os.path.join(tmp, f"a{K}-"), CLI_TRACKS_SCHEME),
                  log=log)
    check(run["rc"] == 0 and len(run["engines"]) == 1, f"{where} exit {run['rc']}: {run['stderr'][-2000:]}")
    eng = run["engines"][0]
    check(eng.device.type == "cuda" and eng.spec.nr_states == K,
          f"{where} engine on {eng.device} with {eng.spec.nr_states} states")
    check_graphed(eng, where)
    streams = check_streams(os.path.join(tmp, f"a{K}-"), ".csv", CLI_TRACKS_T, K, n_params, dim,
                            recorded_sweeps(CLI_TRACKS_SCHEME), truth, where)
    check(streams["segments"] == streams["rows"] == int(eng.buffers.n_boundaries) + 1,
          f"{where} segments vs marginals rows")
    res = {"seconds": run["seconds"], "phases": phase_summary(log), "map_agreement":
           streams["map_agreement"], "drain_ms": [round(1e3 * b, 3) for b in eng.drain.busy],
           "rows": streams["rows"], "sha256": hashlib.sha256(
               open(os.path.join(tmp, f"a{K}-marginals.csv"), "rb").read()).hexdigest()[:16]}
    if K in CLI_TRACKS_EAGER:
        eager = run_cli(cli_tracks_argv(path, states, os.path.join(tmp, f"e{K}-"),
                                        CLI_TRACKS_SCHEME), eager=True)
        check(eager["rc"] == 0 and eager["engines"][0].phase_graphs.replays == 0,
              f"{where} eager run: exit {eager['rc']} {eager['stderr'][-2000:]}")
        check(stream_bytes(os.path.join(tmp, f"e{K}-")) == stream_bytes(os.path.join(tmp, f"a{K}-")),
              f"{where} the graphed engine's streams differ from the eager engine's")
        res["eager_seconds"] = eager["seconds"]
    return res


def cli_tracks_resume(tmp: str, here: str, K: int, path: str, states: list[str]) -> dict:
    """(b) at K: (a)'s argv with -C CLI_TRACKS_CKPT_EVERY in a child process,
    killed (os._exit) right after its first checkpoint, then run again
    with the same argv in this process: it resumes, and its seven files
    are (a)'s bytes. Returns the checkpoint's size, the seconds of each of
    its writes, the resumed run's seconds."""
    where = f"[cli_tracks] (b) K={K}"
    ckpt = os.path.join(tmp, f"b{K}.npz")
    argv = cli_tracks_argv(path, states, os.path.join(tmp, f"b{K}-"), CLI_TRACKS_SCHEME) + [
        "-C", ckpt, str(CLI_TRACKS_CKPT_EVERY)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_TRACKS_KILLED, *argv], capture_output=True,
                          text=True, timeout=600, cwd=here)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 9 and os.path.exists(ckpt),
          f"{where} the child was not killed after its first checkpoint: exit {proc.returncode}, "
          f"{proc.stderr[-2000:]}")
    first = json.loads(proc.stdout.strip().splitlines()[-1])
    check(first["sweeps"] == CLI_TRACKS_CKPT_EVERY, f"{where} first checkpoint at {first}")
    writes = [first["seconds"]]
    real = runner.save_checkpoint

    def timed(engine, p):
        t = time.perf_counter()
        real(engine, p)
        writes.append(time.perf_counter() - t)

    runner.save_checkpoint = timed
    try:
        run = run_cli(argv)
    finally:
        runner.save_checkpoint = real
    check(run["rc"] == 0, f"{where} resumed run: exit {run['rc']} {run['stderr'][-2000:]}")
    check_graphed(run["engines"][0], where)
    check(stream_bytes(os.path.join(tmp, f"b{K}-")) == stream_bytes(os.path.join(tmp, f"a{K}-")),
          f"{where} the resumed run's streams differ from the uninterrupted run's")
    return {"bytes": os.path.getsize(ckpt), "write_s": [round(w, 3) for w in writes],
            "child_s": child_s, "resumed_s": run["seconds"]}


def cli_tracks_chains(tmp: str, files: list[str]) -> dict:
    """(c): cli.main -M over ``files`` (K = 27, three tracks, device ingest)
    with cli._chain_devices giving cuda:0 twice (two threads on the one
    card, taking turns at phases) and once (one chain after the other):
    the same bytes in all seven streams of both chains, one launch of each
    maxlet kernel per chain; seconds and peak memory of each."""
    card = torch.device("cuda", 0)
    res: dict = {}
    outputs = {}
    chain_devices = cli._chain_devices
    try:
        for tag, devs in (("threads", [card] * 2), ("sequential", [card])):
            cli._chain_devices = lambda devs=devs: devs
            prefix = os.path.join(tmp, f"c-{tag}-")
            before = read_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run = run_cli(["-M", "-f", *files, "-o", prefix, ".csv", "-s", "C", "3", "3", "-a",
                           "-R", str(CLI_TRACKS_SEED), "-i", *CLI_TRACKS_SCHEME.split(), "-O",
                           *ALL_STREAMS, "-w"])
            after = read_counts()
            check(run["rc"] == 0 and len(run["engines"]) == 2,
                  f"[cli_tracks] (c) -M ({tag}) exit {run['rc']}: {run['stderr'][-2000:]}")
            for name in MAXLET_NAMES:
                check(after[name] - before[name] == 2,
                      f"[cli_tracks] (c) -M ({tag}) launched {name} {after[name] - before[name]} "
                      "times, not once per chain")
            for eng in run["engines"]:
                check(eng.ing.weights_host is None, "[cli_tracks] (c) a chain took host ingest")
                check_graphed(eng, f"[cli_tracks] (c) -M ({tag})")
            res[tag] = {"seconds": run["seconds"],
                        "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}
            outputs[tag] = {(i, s): open(f"{prefix}chr{i + 1}-{s}.csv", "rb").read()
                            for i in range(len(files)) for s in ALL_STREAMS}
            del run
    finally:
        cli._chain_devices = chain_devices
    check(outputs["threads"] == outputs["sequential"],
          "[cli_tracks] (c) threaded -M chains differ from the sequential ones")
    return res


def cli_tracks_prior(tmp: str, K: int, path: str, truth: np.ndarray, states: list[str],
                     scheme: str, ceiling: int | None, T: int = CLI_TRACKS_T,
                     method: str = "F") -> dict:
    """(e) one run: ``scheme`` (its first ``method`` phase right after a
    prior draw whose threshold is dynamic) with every stream at K on T
    positions, under a capacity ceiling (runner._MAX_CAPACITY, what
    HAMMLET_MAX_CAPACITY sets) or the default. Exit 0: the streams pass
    check_streams (the MAP agreement reported, not gated), no recording
    chunk ran truncated, and under a ceiling the first ``method`` chunk ran
    at it, truncated. Exit 1 (allowed only without a ceiling): one [ERROR]
    message naming the capacity, K and HAMMLET_MAX_CAPACITY, an empty
    marginals file and no recorded sweep in any per-sweep stream. Returns
    the chunk log's phases, the first ``method`` chunk's capacity, seconds
    and peaks, the truncated chunks, the engine (its graphs released) and
    the exit."""
    where = f"[cli_tracks] (e) K={K} '{scheme}' ceiling {ceiling or 'default'}"
    n_params, dim = int(states[1]), int(states[2])
    prefix = os.path.join(tmp, f"p{K}-{len(scheme)}-{ceiling or 0}-")
    log: list = []
    default = runner._MAX_CAPACITY
    runner._MAX_CAPACITY = ceiling or default
    try:
        run = run_cli(cli_tracks_argv(path, states, prefix, scheme), log=log)
    finally:
        runner._MAX_CAPACITY = default
    first = next((r for r in log if r["method"] == method), {})
    res = {"K": K, "scheme": scheme, "ceiling": ceiling, "method": method, "rc": run["rc"],
           "seconds": run["seconds"],
           "first": {k: first.get(k) for k in ("capacity", "max_nb", "seconds", "peak", "reserved",
                                                 "error")},
           "phases": phase_summary(log), "truncated": sum(bool(r.get("truncated")) for r in log),
           "engine": run["engines"][0] if run["engines"] else None}
    if run["rc"] == 0:
        check_graphed(run["engines"][0], where)
        # a burn-in of 16 sweeps from a prior draw (truncated under the ceiling) is too short
        # for a chain to find every level: the agreement is reported, not gated
        streams = check_streams(prefix, ".csv", T, K, n_params, dim,
                                recorded_sweeps(scheme), truth, where, map_min=None)
        res["map_agreement"] = streams["map_agreement"]
        check(not any(r["truncated"] for r in log if r["record"]),
              f"{where} a recording chunk ran truncated")
        if ceiling:
            check(first["capacity"] == ceiling and first["truncated"],
                  f"{where} the first {method} chunk ran at {first['capacity']} blocks, "
                  f"{first.get('max_nb')} needed: not truncated at the ceiling")
    else:
        errors = [ln for ln in run["stderr"].splitlines() if "[ERROR]" in ln]
        check(ceiling is None and run["rc"] == 1 and len(errors) == 1,
              f"{where} exit {run['rc']}, stderr {run['stderr'][-2000:]}")
        for word in (f"capacity {first.get('capacity')}", f"K = {K}", "HAMMLET_MAX_CAPACITY"):
            check(word in errors[0], f"{where} the error does not name {word!r}: {errors[0]}")
        check(os.path.getsize(prefix + "marginals.csv") == 0,
              f"{where} a marginals file was written by a run that failed")
        for s in PER_SWEEP_STREAMS:
            check(os.path.getsize(f"{prefix}{s}.csv") == 0,
                  f"{where} {s} holds recorded sweeps of a run that failed")
        res["error"] = errors[0]
    if res["engine"] is not None:
        res["engine"].phase_graphs.release()
    return res


def prior_draw_inputs(eng) -> tuple:
    """The scan and model-update inputs of one F sweep right after a prior
    draw on ``eng`` (its run over, its graphs released), through the eager
    gibbs_phase: (scans, models, capacity)."""
    vars(eng).pop("_run_chunk", None)  # log_chunks' wrapper of the graphed chunk
    eager_engine(eng)
    eng.records = None
    eng.sample_prior()
    with ScanInputs() as scans, ModelInputs() as models:
        eng.run("F", 1, 0)
    return scans.main_and_others()[0], models.main(), eng.capacity


def phase_cli_tracks(tmp: str) -> dict:
    """[cli_tracks]: (a)-(e) on the data of [states9]-[states81] at
    CLI_TRACKS_T positions per track (and (c) on two inputs of
    CLI_TRACKS_CHAIN_T), every run through cli.main on the card; (f) no
    plain version of a scan or the model update runs (PlainCalls), and
    every kernel launched. Then the kernels at the shapes these runs gave
    them that no earlier phase checks: each maxlet kernel on (c)'s inputs
    (before the runs, not counted), and the scans and the model update of
    one F sweep right after a prior draw at each K of (e), at capacity ~T
    or at the ceiling, against their plain versions and timed."""
    here = os.path.dirname(os.path.abspath(__file__))
    cases = cli_tracks_cases()
    res: dict = {"seconds": {}, "a": {}, "b": {}, "e": []}
    last = [time.perf_counter()]

    def took(part: str) -> None:
        now = time.perf_counter()
        res["seconds"][part] = round(now - last[0], 1)
        last[0] = now

    worst = {"chunk": 0.0, "cross": 0.0, "transform": 0.0}
    chain_files = []
    for i in range(2):
        chain_files.append(os.path.join(tmp, f"chr{i + 1}.txt"))
        np.savetxt(chain_files[-1], states27_steps(CLI_TRACKS_CHAIN_T, seed=STATES27_SEED + 20 + i)[0],
                   fmt="%.5f")
        x_cpu = torch.from_numpy(np.ascontiguousarray(read_values([chain_files[-1]], 3)))
        x = x_cpu.cuda()
        check_kernels(x, x_cpu, worst)
    res["maxlet"] = {**maxlet_times(x), "worst": worst}
    del x, x_cpu
    files = {}
    for K, (tag, steps, states) in cases.items():
        data, truth = steps(CLI_TRACKS_T)
        files[K] = (os.path.join(tmp, f"{tag}.csv"), truth, states)
        np.savetxt(files[K][0], data, fmt="%.5f")
    d81 = cases[81][1](CLI_TRACKS_T)[0]
    torch.cuda.empty_cache()
    took("inputs")
    reset_counts()
    with PlainCalls() as plain:
        for K in cases:
            res["a"][K] = cli_tracks_default(tmp, K, *files[K])
        took("a")
        for K in CLI_TRACKS_RESUME:
            path, _, states = files[K]
            res["b"][K] = cli_tracks_resume(tmp, here, K, path, states)
        took("b")
        res["c"] = cli_tracks_chains(tmp, chain_files)
        took("c")
        res["d"] = phase_debug(d81, "[cli_tracks] (d)")
        took("d")
        for K, scheme, ceiling in CLI_TRACKS_PRIOR_RUNS:
            res["e"].append(cli_tracks_prior(tmp, K, *files[K], scheme, ceiling))
            torch.cuda.empty_cache()
        took("e")
    res["launches"] = read_counts()
    check(not plain.calls, f"[cli_tracks] (f) plain versions ran: {plain.calls}")
    for name, n in res["launches"].items():
        check(n >= 1, f"[cli_tracks] (f) the path never launched {name}")
    # the scans' and the model update's inputs at capacity ~T (K = 9, 27) and at the ceiling (K =
    # 64, 81); not at K = 81 and ~T, whose plain versions this process's memory does not hold
    inputs = {}
    seen = set()
    for run in res["e"]:
        eng = run.pop("engine")
        if (run["rc"] == 0 and (run["ceiling"] or run["K"] <= 27)
                and (run["K"], run["ceiling"]) not in seen):
            seen.add((run["K"], run["ceiling"]))
            scans, models, cap = prior_draw_inputs(eng)
            inputs[f"K={run['K']} B={cap} after a prior draw"] = (scans, models)
        del eng
    torch.cuda.empty_cache()
    res["fbscan"] = time_fbscan({tag: v[0] for tag, v in inputs.items()}, reps=1)
    res["model"] = time_model({tag: v[1] for tag, v in inputs.items()}, reps=1)
    del inputs
    torch.cuda.empty_cache()
    took("kernels")
    return res


def print_cli_tracks(ct: dict) -> None:
    for K, a in ct["a"].items():
        print(f"[cli_tracks] (a) K={K} T={CLI_TRACKS_T} '{CLI_TRACKS_SCHEME}' all 7 streams: "
              f"{a['seconds']:.2f} s (eager {a.get('eager_seconds', float('nan')):.2f} s, same "
              f"bytes: {K in CLI_TRACKS_EAGER}), phases (method, sweeps, first capacity, peak MiB "
              f"allocated above a chunk's start, peak MiB reserved by the process, s) "
              f"{a['phases']}, drain ms per chunk on the worker "
              f"{a['drain_ms']}, {a['rows']} marginal rows, MAP agreement {a['map_agreement']:.4f}, "
              f"marginals sha256 {a['sha256']}; stream checks passed", flush=True)
    for K, b in ct["b"].items():
        print(f"[cli_tracks] (b) K={K} -C {CLI_TRACKS_CKPT_EVERY}: killed after its first "
              f"checkpoint ({b['child_s']:.2f} s), resumed in {b['resumed_s']:.2f} s, the "
              f"uninterrupted run's bytes; checkpoint {b['bytes']} bytes, writes {b['write_s']} s",
              flush=True)
    c = ct["c"]
    print(f"[cli_tracks] (c) -M two inputs of T={CLI_TRACKS_CHAIN_T} x 3 (device ingest) on one "
          f"card: threads {c['threads']['seconds']:.2f} s (peak {c['threads']['peak_mib']:.1f} MiB "
          f"allocated above the run's start), one after another {c['sequential']['seconds']:.2f} s "
          f"(peak {c['sequential']['peak_mib']:.1f} MiB); all 7 streams byte-identical; maxlet at dim 3 "
          f"on these inputs bitwise, flushed ms chunk {ct['maxlet']['chunk']:.4f} (bound "
          f"{ct['maxlet']['chunk_bound']:.4g}), cross {ct['maxlet']['cross']:.4f}", flush=True)
    print(f"[cli_tracks] (d) HAMMLET_DEBUG=1 at K={ct['d']['K']}: healthy F chunk error bits 0; NaN "
          f"emission mean raised FloatingPointError ({ct['d']['seconds']:.2f} s)", flush=True)
    for e in ct["e"]:
        f = e["first"]
        print(f"[cli_tracks] (e) K={e['K']} '{e['scheme']}' HAMMLET_MAX_CAPACITY "
              f"{e['ceiling'] or 'unset'}: exit {e['rc']} in {e['seconds']:.2f} s; first F chunk "
              f"capacity {f['capacity']} (sweeps needed up to {f['max_nb']} blocks), "
              f"{f['seconds'] if f['seconds'] is None else round(f['seconds'], 3)} s, peak "
              f"{(f['peak'] or 0) / 2**20:.1f} MiB allocated above its start, "
              f"{(f['reserved'] or 0) / 2**20:.1f} reserved by the process; truncated chunks "
              f"{e['truncated']}; phases {e['phases']}"
              + (f"; MAP agreement {e['map_agreement']:.4f}" if "map_agreement" in e else "")
              + (f"; error: {e['error']}" if "error" in e else ""), flush=True)
    for tag, row in ct["fbscan"].items():
        m = ct["model"][tag]
        print(f"[cli_tracks] {tag}: both scans and both model-update kernels against their plain "
              f"versions on the sweep's own inputs (prefix bitwise {row['bitwise']}); kernels "
              f"prefix {[kernel_label(n) for n, _ in row['prefix_kernels']]}, suffix "
              f"{[kernel_label(n) for n, _ in row['suffix_kernels']]}; ms flushed (bound): prefix "
              f"{row['prefix']:.4f} ({row['prefix_bound']:.4g}), plain {row['prefix_plain']:.4f}; "
              f"suffix {row['suffix']:.4f} ({row['suffix_bound']:.4g}), plain "
              f"{row['suffix_plain']:.4f}; statistics {m['stats']:.4f} ({m['stats_bound']:.4g}), "
              f"plain {m['stats_plain']:.4f}; resample {m['resample']:.4f}, plain "
              f"{m['resample_plain']:.4f}", flush=True)
    print(f"[cli_tracks] (f) no plain version ran; launches {ct['launches']}; seconds "
          f"{ct['seconds']}", flush=True)


class BigData:
    """bench.py's recipe (synth) at any T, made range by range: a provider
    ``f(start, stop) -> (stop - start, 1) float32`` for make_sharded_engine.
    The segment states come from one generator (seed), the noise of each
    NOISE_BLOCK positions from its own generator (seed, block), so that a
    process makes only its own ranges and every process sees the same
    data."""

    def __init__(self, T: int, seed: int):
        self.T, self.seed = T, seed
        n_seg = max(1, T // SEGLEN)
        self.states = np.random.default_rng(seed).integers(0, 3, size=n_seg)
        self.seg_sizes = np.full(n_seg, SEGLEN, dtype=np.int64)
        self.seg_sizes[-1] = T - SEGLEN * (n_seg - 1)
        self.means = np.array([0.0, 2.0, -2.0], dtype=np.float32)

    def __call__(self, start: int, stop: int) -> np.ndarray:
        seg = np.minimum(np.arange(start, stop) // SEGLEN, len(self.states) - 1)
        out = self.means[self.states[seg]]
        for b in range(start // NOISE_BLOCK, -(-stop // NOISE_BLOCK)):
            lo, hi = max(start, b * NOISE_BLOCK), min(stop, (b + 1) * NOISE_BLOCK)
            noise = np.random.default_rng([self.seed, b]).standard_normal(NOISE_BLOCK, dtype=np.float32)
            out[lo - start : hi - start] += noise[lo - b * NOISE_BLOCK : hi - b * NOISE_BLOCK]
        return out[:, None]

    def truth(self) -> np.ndarray:
        """(T,) int8 true state per position."""
        return np.repeat(self.states.astype(np.int8), self.seg_sizes)


def live_workers(launcher_pid: int) -> list[int]:
    """Processes that a launcher with this pid started and that still run
    (parallel/launch.py gives its workers HAMMLET_LAUNCHER_PID)."""
    mark = f"HAMMLET_LAUNCHER_PID={launcher_pid}".encode()
    pids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/environ", "rb") as fh:
                    if mark in fh.read().split(b"\0"):
                        pids.append(int(entry))
            except OSError:
                pass
    return pids


def cards_kernels(n: int) -> dict:
    """[cards] (a): on each of n cards, both maxlet kernels against their
    plain versions and the golden transform at T_MAIN, dim 1 (the main
    path's data) and dim 3, bit for bit; both FB scan kernels and both
    model-update kernels against their plain versions at B = 29,696, K = 3,
    one and four rows, bit for bit."""
    worst = {"chunk": 0.0, "cross": 0.0, "transform": 0.0, "golden": 0.0}
    for data in (synth(T_MAIN, SEED)[0][:, None],
                 np.random.default_rng(T_MAIN * 7 + 3).normal(1, 2, (T_MAIN, 3)).astype(np.float32)):
        data = np.ascontiguousarray(data)
        want = torch.from_numpy(golden.maxlet_transform(data))
        for i in range(n):
            with torch.cuda.device(i):
                x = torch.from_numpy(data).to(torch.device("cuda", i))
                check_kernels(x, None, worst)
                check_golden(x, want, worst)
    for i in range(n):  # the FB scan kernels at the main path's shape, 1 and 4 rows
        with torch.cuda.device(i):
            for R in (1, 4):
                M, maps = fb_inputs(29_696, 3, R, SEED + i)
                check(bits_equal(fb_cuda.prefix_matmul_scan_cuda(M), fb.prefix_matmul_scan_reference(M))
                      and torch.equal(fb_cuda.suffix_compose_scan_cuda(maps),
                                      fb.suffix_compose_scan_reference(maps)),
                      f"[cards] (a) an FB scan kernel != its plain version on cuda:{i} (R={R})")
                check_model(model_stats_inputs(R, 29_696, 3, 1, SEED + i),
                            model_resample_inputs(3, SEED + i), f"[cards] (a) cuda:{i}, R={R}")
    return worst


# [cards]: (b) and (c) on the main path's data (K = 3), (g) both again on states27_steps' three
# tracks (-s C 3 3, K = 27): the labels of the two parts, -s arguments, nr_params, dim
CARDS_CASES = {"main": (("[cards] (b)", "[cards] (c)"), ["3"], 3, 1),
               "tracks": (("[cards] (g)", "[cards] (g)"), ["C", "3", "3"], 3, 3)}


def cards_data(case: str) -> tuple[np.ndarray, np.ndarray]:
    """The data and true states of a CARDS_CASES case at T_MAIN positions."""
    return synth(T_MAIN, SEED) if case == "main" else states27_steps(T_MAIN)


def cards_cli(n: int, tmp: str, case: str) -> dict:
    """[cards] (b) and (g): the case's data (CARDS_CASES) and SCHEME as a
    text file through bin/hammlet-torch -s ... -D n -C: spanning n cards (n
    processes), under CUDA_VISIBLE_DEVICES=0 (one process), and spanning n
    cards killed after its first checkpoint and run again; the three write
    the same bytes; the marginal rows cover T, have K columns and count the
    recorded sweeps, MAP agreement >= MAP_AGREEMENT_MIN."""
    (label, _), states, nr_params, dim = CARDS_CASES[case]
    data, truth = cards_data(case)
    K = nr_params**dim
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "d.txt")
    t0 = time.perf_counter()
    with open(path, "w") as fh:  # shortest round-trip text of each float32
        fh.write("\n".join(" ".join(map(repr, row))
                           for row in data.reshape(T_MAIN, dim).astype(np.float64).tolist()) + "\n")
    res: dict = {"write_s": time.perf_counter() - t0}
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
    streams = ("marginals", "parameters", "compression")

    def argv(tag: str) -> list[str]:
        return [sys.executable, os.path.join(here, "bin", "hammlet-torch"), "-f", path, "-s",
                *states, "-a", "-R", str(SEED), "-D", str(n), "-i", *SCHEME.split(), "-O",
                *streams, "-o", os.path.join(tmp, tag + "-"), ".csv", "-w", "-v",
                "-C", os.path.join(tmp, tag + ".npz"), str(CARDS_CKPT_EVERY)]

    def run(tag: str, extra_env: dict | None = None) -> tuple:
        t0 = time.perf_counter()
        proc = subprocess.run(argv(tag), env={**env, **(extra_env or {})}, capture_output=True,
                              text=True, timeout=900)
        check(proc.returncode == 0, f"{label} {tag} run exited {proc.returncode}: "
              f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
        outs = {s: open(os.path.join(tmp, f"{tag}-{s}.csv"), "rb").read() for s in streams}
        return proc.stdout, time.perf_counter() - t0, outs

    spanned = f"Cards: {torch.cuda.device_count()}; -D {n}: {n} processes, one per card"
    out, res["cards_s"], want = run("cards")
    check(spanned in out and "Processes: " in out and f"States: {K}" in out,
          f"{label} -D {n} did not span {n} cards: {out[-2000:]}")
    out, res["one_s"], got = run("one", {"CUDA_VISIBLE_DEVICES": "0"})
    check("Cards:" not in out and "Device: cuda:0" in out, f"{label} one card: {out[-2000:]}")
    for s in streams:
        check(got[s] == want[s], f"{label} -D {n} on one card: {s} differs from {n} cards")

    ck = os.path.join(tmp, "cut.npz")
    proc = subprocess.Popen(argv("cut"), env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 600
    while not os.path.exists(ck) and proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.01)
    proc.kill()
    proc.wait()
    check(proc.returncode == -9, f"{label} the cut run ended on its own ({proc.returncode}) "
          "before its cut")
    with np.load(ck) as z:
        res["cut_at"] = int(z["sweeps_completed"])
    for _ in range(300):  # the workers die with their launcher
        res["left"] = live_workers(proc.pid)
        if not res["left"]:
            break
        time.sleep(0.1)
    check(not res["left"], f"{label} workers {res['left']} outlived their killed launcher")
    out, res["resume_s"], got = run("cut")
    check(f"Resumed from {ck} at sweep {res['cut_at']}" in out, f"{label} no resume: {out[-2000:]}")
    for s in streams:
        check(got[s] == want[s], f"{label} the cut and resumed run: {s} differs")
    res["sha256"] = {s: hashlib.sha256(want[s]).hexdigest()[:16] for s in ("marginals", "parameters")}
    sizes, counts = read_marginals(os.path.join(tmp, "cards-marginals.csv"))
    check(counts.shape[1] == K and int(sizes.sum()) == T_MAIN
          and bool((counts.sum(axis=1) == N_RECORDED).all()),
          f"{label} marginal rows do not cover T or sum to the recorded sweeps")
    res["rows"] = len(sizes)
    res["map_agreement"] = map_agreement(sizes, counts, truth)
    check(res["map_agreement"] >= MAP_AGREEMENT_MIN, f"{label} MAP agreement {res['map_agreement']}")
    return res


def profile_nccl(eng, iters: int = 64) -> dict:
    """torch.profiler over ``F iters 4``: the CUDA runtime's launch calls by
    name (LAUNCH_CALLS), CUDA kernels, NCCL kernels and their device ms,
    each per sweep; and the host ms per sweep inside the collective calls
    (the profiler's "c10d::" operator events)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ])
    with prof:
        eng.run("F", iters, 4)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    nccl = [e for e in kernels if e.name.startswith(("ncclDevKernel", "ncclKernel"))]
    calls = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("c10d::")]
    launches: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS:
            launches[e.name] = launches.get(e.name, 0) + 1
    return {
        "launch_calls": {k: v / iters for k, v in sorted(launches.items())},
        "kernels_per_sweep": len(kernels) / iters,
        "device_ms_per_sweep": sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3,
        "nccl_kernels_per_sweep": len(nccl) / iters,
        "nccl_ms_per_sweep": sum(e.time_range.elapsed_us() for e in nccl) / iters / 1e3,
        "nccl_kernel_us": [float(np.percentile([e.time_range.elapsed_us() for e in nccl], q))
                           for q in (0, 50, 90)] if nccl else None,
        "nccl_names": sorted({e.name for e in nccl}),
        "collective_calls_per_sweep": len(calls) / iters,
        "collective_host_ms_per_sweep": sum(e.time_range.elapsed_us() for e in calls) / iters / 1e3,
        "fbscan_per_sweep": {name: sum(e.name == name for e in kernels) / iters
                             for name in sorted({e.name for e in kernels if "fbscan_" in e.name})},
    }


def cards_rates(n: int, pairs: int, case: str) -> dict:
    """[cards] (c) and (g), in each process of an n-process group (one card
    each, launch.run_on_cards): the case's data (CARDS_CASES) and SCHEME
    through the sharded engine with one shard per card (W = n), graphed and
    with its chunks through the eager sharded_phase (rank 0 checks that the
    two wrote the same bytes; every rank must have captured the same
    graphs), and on rank 0 also through the single-device engine (P = 1)
    and the sharded engine with n shards on card 0 (P = n); then settled F
    512 4 phases in ``pairs`` rotations of the four (the other ranks wait
    at a barrier while rank 0 runs P = 1 or P = n alone), then
    torch.profiler on rank 0 over F 64 4 of W = n, graphed and eager.
    Returns rank 0's sweeps/s, profiles and graph counters, and every
    rank's."""
    rank = torch.distributed.get_rank()
    dev = distributed.process_device()
    (_, where), _, nr_params, dim = CARDS_CASES[case]
    data = cards_data(case)[0]
    mpc = ("marginals", "parameters", "compression")
    with tempfile.TemporaryDirectory() as tmp:

        def records(tag: str) -> Records:
            return Records(T_MAIN, os.path.join(tmp, tag + "-"), ".csv", nr_params**dim,
                           outputs=set(mpc), overwrite=True, write=rank == 0)

        model = {"nr_params": nr_params, "nr_data_dim": dim, "seed": SEED}
        engines = {tag: sharded.make_sharded_engine(data, mesh=position_mesh(n), records=records(tag),
                                                    **model)
                   for tag in ("cards", "eager")}
        eager_sharded_engine(engines["eager"])
        if rank == 0:
            engines["one"] = runner.make_engine(data, records=records("one"), device=dev, **model)
            engines["shards"] = sharded.make_sharded_engine(
                data, mesh=PositionMesh(n, dev), records=records("shards"), **model)
        for eng in engines.values():
            eng.run_scheme(SCHEME.split())
            eng.finalize()
        pg = engines["cards"].phase_graphs
        check_graphed(engines["cards"], where)
        check(pg.graphs >= 4 * pg.captures, f"{where} {pg.graphs} graphs for {pg.captures} "
              "sweep kinds: the collectives are not between the graphs")
        mine = torch.tensor([pg.captures, pg.graphs, pg.replays], device=dev)
        every = engines["cards"].mesh.all_gather(mine[None])
        check(bool((every == mine).all()), f"{where} the ranks captured different graphs: "
              f"{every.tolist()}")
        check(engines["eager"].phase_graphs.replays == 0, f"{where} the eager engine replayed graphs")
        if rank == 0:
            for s_ in mpc:
                got, want = (open(os.path.join(tmp, f"{t}-{s_}.csv"), "rb").read()
                             for t in ("cards", "eager"))
                check(got == want, f"{where} W={n} graphed and eager {s_} differ")
        torch.distributed.barrier()
        tags = ("cards", "eager", "one", "shards")
        order = [tags[(i + j) % 4] for j in range(pairs) for i in range(4)]
        rates: dict = {t: [] for t in tags}
        for turn, tag in enumerate(order):
            if tag in ("cards", "eager") or rank == 0:
                eng = engines[tag]
                eng.records = records(f"{tag}{turn}")
                eng.run("F", 512, 4)
                eng.records.close()
                rates[tag].append(512 / eng.phase_log[-1][2])
            torch.distributed.barrier()
        prof = {}
        for tag in ("cards", "eager"):
            eng = engines[tag]
            eng.records = None
            prof[tag] = profile_nccl(eng) if rank == 0 else eng.run("F", 64, 4)
            torch.distributed.barrier()
    return {"order": order, "rates": rates, "profile": prof["cards"], "eager_profile": prof["eager"],
            "cap_local": engines["cards"].cap_local,
            "captures": [pg.captures, pg.graphs, round(pg.capture_seconds, 4)],
            "graphs": every.tolist()}


def cards_big(n: int, T: int) -> dict:
    """[cards] (d), in each process of an n-process group: T positions of
    BigData, made by each process for its own shards, through the sharded
    engine with one shard per card, BIG_SCHEME, marginals; setup seconds,
    M and F sweeps/s, each card's peak memory; rank 0 checks the marginal
    rows and the MAP agreement."""
    rank = torch.distributed.get_rank()
    dev = distributed.process_device()
    data = BigData(T, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "big-")
        rec = Records(T, prefix, ".csv", 3, outputs={"marginals"}, overwrite=True, write=rank == 0)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = sharded.make_sharded_engine(data, mesh=position_mesh(n), T=T, dim=1, nr_params=3,
                                          seed=SEED, records=rec)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        eng.run_scheme(BIG_SCHEME.split())
        eng.finalize()
        torch.cuda.synchronize(dev)
        total_s = time.perf_counter() - t0
        check_graphed(eng, "[cards] (d)")
        peak = eng.mesh.all_gather(
            torch.tensor([torch.cuda.max_memory_allocated(dev)], device=dev)).tolist()
        pg = eng.phase_graphs
        res = {"T": T, "setup_s": setup_s, "total_s": total_s, "peak_mem_bytes": peak,
               "cap_local": eng.cap_local, "last_n_blocks": eng.last_n_blocks,
               "captures": [pg.captures, pg.graphs, round(pg.capture_seconds, 4)],
               "phases": [(m, k, round(s, 4)) for m, k, s in eng.phase_log]}
        for method in ("M", "F"):
            res[method] = (sum(k for m, k, _ in eng.phase_log if m == method)
                           / sum(s for m, _, s in eng.phase_log if m == method))
        if rank == 0:
            sizes, counts = read_marginals(prefix + "marginals.csv")
            check(int(sizes.sum()) == T, f"[cards] big run: marginal rows cover {sizes.sum()}, not {T}")
            check(bool((counts.sum(axis=1) == BIG_RECORDED).all()),
                  f"[cards] big run: marginal rows do not count {BIG_RECORDED} sweeps")
            res["rows"] = len(sizes)
            res["map_agreement"] = map_agreement(sizes, counts, data.truth())
            check(res["map_agreement"] >= MAP_AGREEMENT_MIN,
                  f"[cards] big run: MAP agreement {res['map_agreement']:.4f}")
    return res


def sharded_cards(n: int, pairs: int = CARDS_PAIRS, t_big: int = T_BIG) -> int:
    """``chip_smoke.py --sharded-cards N [PAIRS [T]]``: [cards] alone, -D N
    over N cards, one process per card over NCCL; needs N cards."""
    check(torch.cuda.device_count() >= n, f"--sharded-cards {n} needs {n} cards")
    print(f"[card] {nvidia_smi_line()} | torch {torch.__version__} (cuda {torch.version.cuda}) | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    wavelet_cuda.build()
    worst = cards_kernels(n)
    print(f"[cards] (a) maxlet_chunk_kernel and maxlet_cross_kernel bitwise equal to their plain "
          f"versions and to golden.reference.maxlet_transform on each of cuda:0-{n - 1}, T={T_MAIN} "
          f"dim 1 and 3 (max abs errors {worst}); prefix_matmul_scan_kernel and "
          "suffix_compose_scan_kernel, and the sweep statistics and resample kernels, bitwise "
          "equal to their plain versions on each card at B=29696 K=3, R 1 and 4", flush=True)
    b, c = cards_case(n, pairs, "main")
    rc, d = launch.run_on_cards("chip_smoke:cards_big", n, (n, t_big))
    check(rc == 0 and d is not None, f"[cards] (d) exited {rc}")
    print(f"[cards] (d) T={d['T']} (chr1 at 1 bp, made in each process) '{BIG_SCHEME}' -D {n} on "
          f"{n} cards, graphed (sweep kinds, graphs, capture seconds on rank 0 "
          f"{d['captures']}): setup {d['setup_s']:.2f} s, total {d['total_s']:.2f} s, M {d['M']:.3f} / "
          f"F {d['F']:.3f} sweeps/s, peak device memory per card "
          f"{[round(p / 2**30, 3) for p in d['peak_mem_bytes']]} GiB, cap_local {d['cap_local']}, "
          f"last blocks {d['last_n_blocks']}, {d['rows']} marginal rows cover T and count "
          f"{BIG_RECORDED} sweeps each, MAP agreement {d['map_agreement']:.4f}, phases "
          f"{d['phases']}", flush=True)
    g = dict(zip(("cli", "rates"), cards_case(n, pairs, "tracks")))
    print(json.dumps({"cards": {"a": worst, "b": b, "c": c, "d": d, "g": g}}), flush=True)
    return 0


def cards_case(n: int, pairs: int, case: str) -> tuple[dict, dict]:
    """[cards] (b) and (c), or (g): cards_cli on the case's data, then
    cards_rates in an n-process group; prints their lines and returns both
    results."""
    (cli_label, rates_label), states, nr_params, dim = CARDS_CASES[case]
    with tempfile.TemporaryDirectory() as tmp:
        b = cards_cli(n, tmp, case)
    print(f"{cli_label} T={T_MAIN} x {dim} track(s) K={nr_params**dim} (-s {' '.join(states)}) "
          f"'{SCHEME}' marginals+parameters+compression, bin/hammlet-torch -D {n} -C ... "
          f"{CARDS_CKPT_EVERY} (text file written in {b['write_s']:.2f} s): {n} processes on {n} "
          f"cards {b['cards_s']:.2f} s, one process under CUDA_VISIBLE_DEVICES=0 {b['one_s']:.2f} s, "
          f"byte-identical; killed after its first checkpoint (sweep {b['cut_at']}, no worker left) "
          f"and resumed {b['resume_s']:.2f} s, byte-identical (sha256 {b['sha256']}); {b['rows']} "
          f"marginal rows cover T and count {N_RECORDED} sweeps, MAP agreement "
          f"{b['map_agreement']:.4f}", flush=True)
    rc, c = launch.run_on_cards("chip_smoke:cards_rates", n, (n, pairs, case))
    check(rc == 0 and c is not None, f"{rates_label} exited {rc}")
    r = c["rates"]
    print(f"{rates_label} settled F 512 4 at T={T_MAIN} x {dim} K={nr_params**dim}, sweeps/s in the "
          f"order {' '.join(c['order'])}: W={n} (one shard per card) graphed {r['cards']}, eager "
          f"{r['eager']}, P=1 on cuda:0 {r['one']}, P={n} on cuda:0 (graphed) {r['shards']}; W={n} "
          f"graphed vs eager: {pair_summary(r['cards'], r['eager'], True)}; W={n} vs P={n} on one "
          f"card: {pair_summary(r['cards'], r['shards'], True)}; medians W={n} "
          f"{np.median(r['cards']):.2f} / P=1 {np.median(r['one']):.2f} / P={n} "
          f"{np.median(r['shards']):.2f}; cap_local {c['cap_local']}; W={n} graphed and eager "
          f"byte-identical; sweep kinds captured, graphs, capture seconds on rank 0 "
          f"{c['captures']}; every rank's sweep kinds, graphs and replays {c['graphs']}", flush=True)
    for tag, pr in (("graphed", c["profile"]), ("eager", c["eager_profile"])):
        print(f"{rates_label} torch.profiler F 64 4 on rank 0, W={n} {tag}: launch calls per sweep "
              f"{pr['launch_calls']}, {pr['kernels_per_sweep']} CUDA kernels/sweep, "
              f"{pr['device_ms_per_sweep']:.4f} device ms/sweep, of them "
              f"{pr['nccl_kernels_per_sweep']} NCCL kernels/sweep, {pr['nccl_ms_per_sweep']:.4f} "
              f"NCCL device ms/sweep, one NCCL kernel's us min / median / 90th percentile "
              f"{pr['nccl_kernel_us']} ({pr['nccl_names']}); on the host "
              f"{pr['collective_calls_per_sweep']} collective calls and "
              f"{pr['collective_host_ms_per_sweep']:.4f} ms per sweep inside them; FB scan kernels "
              f"per sweep {pr['fbscan_per_sweep']}", flush=True)
    return b, c


def chains_across_cards(n: int, pairs: int = 2) -> int:
    """``chip_smoke.py --chains-cards N [PAIRS]``: [chains] alone with one
    chain per card on N cards (threads) against the N chains one after
    another on cuda:0, in PAIRS pairs, the -M layout of a multi-GPU node;
    needs N cards."""
    check(torch.cuda.device_count() >= n, f"--chains-cards {n} needs {n} cards")
    print(f"[card] {nvidia_smi_line()} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    order = alternating("sequential", "threads", pairs)
    with tempfile.TemporaryDirectory() as tmp:
        ch = phase_chains(tmp, [torch.device("cuda", i) for i in range(n)], order)
    print(f"[chains] -M with {n} chromosomes of T={T_CHAIN} '{CHAIN_SCHEME}' in the order "
          f"{' '.join(order)}: {n} threads on cuda:0-{n - 1} {ch['threads_s']} s, one "
          f"after another on cuda:0 {ch['sequential_s']} s (ratio of medians "
          f"{ch['ratio']:.3f}; {pair_summary(ch['threads_s'], ch['sequential_s'], False)}); "
          f"marginals, parameters and compression byte-identical; maxlet "
          f"launches in the first threaded run {ch['threads_launches']}", flush=True)
    return 0


def alternating(a: str, b: str, pairs: int) -> tuple:
    """``pairs`` pairs of a and b, the side that runs first alternating."""
    return tuple(x for j in range(pairs) for x in ((a, b) if j % 2 == 0 else (b, a)))


def pair_summary(x: list[float], y: list[float], higher_is_better: bool) -> str:
    """x against y run in pairs (the j-th of each list form pair j): the
    pairs x won, ties counting for neither, and each side's median and
    distance between its quartiles."""
    wins = sum((a > b) if higher_is_better else (a < b) for a, b in zip(x, y))
    iqr = [float(np.subtract(*np.percentile(v, [75, 25]))) for v in (x, y)]
    return (f"{wins} of {len(x)} pairs won; medians {np.median(x):.4f} / {np.median(y):.4f}, "
            f"quartile distances {iqr[0]:.4f} / {iqr[1]:.4f}")


def measure_turns(pairs: int) -> int:
    """``chip_smoke.py --turns N``: on one card, N pairs (the side that
    runs first alternating) of [settled]'s all-streams phase with the drain
    on its worker against the drain inline, after one marginals+parameters+
    compression phase; then N pairs of [chains]' threaded -M against the
    sequential -M."""
    print(f"[card] {nvidia_smi_line()} | {torch.cuda.get_device_name(0)}", flush=True)
    wavelet_cuda.build()
    m = phase_main_path()
    print(f"[main] T={T_MAIN} '{SCHEME}': sha256 of the marginals and parameters files "
          f"{m['sha256']}", flush=True)
    st = phase_settled(m["engine"], ("mpc",) + alternating("all", "inline", pairs))
    print(f"[settled] T={T_MAIN} F {SETTLED_ITERS} 4, capacity {st['capacity']}: all streams, "
          f"drain on its worker {st['all_sweeps_per_s']} vs inline {st['inline_sweeps_per_s']} "
          f"sweeps/s: {pair_summary(st['all_sweeps_per_s'], st['inline_sweeps_per_s'], True)}; "
          f"marginals+parameters+compression {st['mpc_sweeps_per_s']} sweeps/s; drain "
          f"{st['drain_ms']:.3f} ms per chunk on the worker, launching thread waited "
          f"{st['waited_ms_per_chunk']:.3f} ms per chunk", flush=True)
    g = phase_graph(pairs)
    print_graph(g)
    order = tuple(x for j in range(pairs) for x in
                  (("sequential", "threads", "free"), ("free", "threads", "sequential"))[j % 2])
    with tempfile.TemporaryDirectory() as tmp:
        ch = phase_chains(tmp, order=order)
    print(f"[chains] -M with two chromosomes of T={T_CHAIN} '{CHAIN_SCHEME}' on cuda:0 in the "
          f"order {' '.join(order)}, seconds: two threads taking turns {ch['threads_s']} vs one "
          f"after another {ch['sequential_s']}: "
          f"{pair_summary(ch['threads_s'], ch['sequential_s'], False)}; two threads without "
          f"turns {ch['free_s']} vs one after another: "
          f"{pair_summary(ch['free_s'], ch['sequential_s'], False)}; without turns vs with: "
          f"{pair_summary(ch['free_s'], ch['threads_s'], False)}; byte-identical", flush=True)
    return 0


def print_graph(g: dict) -> None:
    """The [graph] lines."""
    for tag in ("graph", "eager"):
        print(f"[graph] T={T_MAIN} '{SCHEME}' {tag}: peak device memory "
              f"{g[tag]['peak_mem_bytes'] / 2**20:.1f} MiB, phases {g[tag]['phases']}, captures "
              f"per phase (method, sweeps, captures, seconds) {g[tag]['captures']}", flush=True)
    st = g["settled"]
    print(f"[graph] graphed and eager engines wrote the same bytes (marginals, parameters, "
          f"compression); settled F {SETTLED_ITERS} 4 (capacity {g['capacity']}) graphed "
          f"{st['graph']} vs eager {st['eager']} sweeps/s: "
          f"{pair_summary(st['graph'], st['eager'], True)}; ratio of medians "
          f"{np.median(st['graph']) / np.median(st['eager']):.3f}", flush=True)
    b = g["one_card"]
    print(f"[graph] T={b['T']} '{ONE_CARD_SCHEME}' on one card with graphs: setup "
          f"{b['setup_s']:.2f} s, total {b['total_s']:.2f} s, M {b['M']:.3f} / F {b['F']:.3f} "
          f"sweeps/s, peak device memory {b['peak_mem_bytes'] / 2**30:.3f} GiB, capacity "
          f"{b['capacity']}, {b['rows']} marginal rows cover T and count {ONE_CARD_RECORDED} "
          f"sweeps each, MAP agreement {b['map_agreement']:.4f}, phases {b['phases']}, captures "
          f"{b['captures']}", flush=True)


def print_sharded(sh: dict, main_rate: float) -> None:
    """The [sharded] lines."""
    st = sh["settled"]
    print(f"[sharded] T={T_MAIN} K=3 '{SCHEME}' P={P_SHARDED} shards on one card, graphed: "
          f"setup {sh['setup_s']:.3f} s (host ingest alone {sh['ingest_s']:.3f} s), "
          f"F-phase {sh['f_sweeps_per_s']:.2f} sweeps/s (first run) vs [main] P=1 "
          f"{main_rate:.2f}; cap_local {sh['cap_local']}, last blocks {sh['last_n_blocks']}, "
          f"peak device memory {sh['peak_mem_bytes'] / 2**20:.1f} MiB (eager "
          f"{sh['eager_peak_mem_bytes'] / 2**20:.1f} MiB), MAP agreement "
          f"{sh['map_agreement']:.4f}, maxlet launches on this path {sh['launches']}; sweep kinds "
          f"captured, graphs, capture seconds {sh['captures']}; eager phases {sh['eager_phases']}",
          flush=True)
    print(f"[sharded] settled F 512 4 in the order {' '.join(sh['settled_order'])}: P=1 "
          f"{st['one']}, P={P_SHARDED} graphed {st['sharded']} vs eager {st['eager']} sweeps/s: "
          f"{pair_summary(st['sharded'], st['eager'], True)}; ratio of medians graphed/eager "
          f"{sh['graph_ratio']:.4f}, graphed P={P_SHARDED}/P=1 {sh['settled_ratio']:.4f}; "
          f"(h) graphed and eager engines byte-identical (marginals, parameters, compression), "
          f"(a) weights bitwise = ingest_device's (kernel), (b) partition of "
          f"{sh['n_blocks']} blocks = single-device's, (c) rows sum to {N_RECORDED}, "
          "(d) eager F chunk under sync debug mode 'error', (e) NCCL world-size-1 run "
          f"byte-identical, its collectives between segment graphs (kinds, graphs, seconds "
          f"{sh['nccl_captures']}), (f) resume into a graphed engine bitwise, (g) "
          f"bin/hammlet-torch -D {P_SHARDED} with one card visible ran in one process (NVML and "
          f"torch count {sh['cards']} cards)", flush=True)


def print_tracks(tag: str, s9: dict, what: str, states: str, cli_T: int) -> None:
    """The [states9], [states27], [states64] or [states81] lines: ``what``
    names the configuration, ``states`` its -s arguments."""
    g = s9["graph"]
    rates = s9["settled"]
    print(f"[{tag}] T={T_MAIN} x {s9['dim']} tracks K={s9['K']} ({what}, -s {states}) '{SCHEME}', "
          f"device ingest: setup {g['setup_s']:.3f} s, total {g['total_s']:.3f} s, capacity "
          f"{g['capacity']}, peak device memory {g['peak_mem_bytes'] / 2**20:.1f} MiB (eager "
          f"{s9['eager']['peak_mem_bytes'] / 2**20:.1f} MiB; per phase (phase, sweeps, MiB, "
          f"capacity at its end) {[(m, n, round(b / 2**20, 1), c) for m, n, b, c in g['peaks']]}), "
          f"MAP agreement {s9['map_agreement']:.4f}, rows sum to {N_RECORDED}, launches "
          f"{g['launches']}, phases {g['phases']}, captures per phase {g['captures']}; every sweep "
          f"a CUDA graph replay; graphed and eager engines byte-identical (marginals, parameters, "
          f"compression; sha256 {s9['sha256']}); settled F {s9['settled_iters']} 4 {rates} sweeps/s "
          f"(median {np.median(rates):.2f}, spread {min(rates):.2f}-{max(rates):.2f}), settled "
          f"capacity {s9['settled_capacity']}", flush=True)
    mx = s9["maxlet"]
    print(f"[{tag}] maxlet kernels at T={T_MAIN} dim={s9['dim']} on this data, ms with L2 flushed "
          "(bound): " + "; ".join(f"{k} {mx[k]:.4f} ({mx[k + '_bound']:.4g} by {mx[k + '_bound_by']}, "
                                  f"{mx[k + '_bound'] / mx[k]:.1%}), plain {mx[k + '_plain']:.4f}"
                                  for k in ("chunk", "cross")), flush=True)
    c = s9["cli"]
    print(f"[{tag}] bin/hammlet-torch -s {states} -a at T={cli_T} x {s9['dim']} (host ingest) "
          f"'{SCHEME}' on the card: {c['seconds']:.2f} s, {c['rows']} marginal rows, MAP agreement "
          f"{c['map_agreement']:.4f}", flush=True)


def print_sharded_tracks(st: dict, p1_rates: list) -> None:
    """The [sharded_tracks] line of one configuration, beside the same
    run's P = 1 settled rates of the same data (``p1_rates``)."""
    rates = st["settled"]
    print(f"[sharded_tracks] K={st['K']} (-s {' '.join(st['states'])}: {st['dim']} tracks x "
          f"T={T_MAIN}, [{st['tag']}]'s data) P={P_SHARDED} shards on one card '{st['scheme']}': "
          f"setup {st['setup_s']:.3f} s, graphed run {st['run_s']:.3f} s, peak device memory "
          f"{st['peak_mem_bytes'] / 2**20:.1f} MiB (per phase (phase, sweeps, MiB, capacity per "
          f"shard at its end) {[(m, n, round(b / 2**20, 1), c) for m, n, b, c in st['peaks']]}; "
          f"eager run {st['eager_peak_mem_bytes'] / 2**20:.1f} MiB), MAP agreement "
          f"{st['map_agreement']:.4f}, {st['rows']} marginal rows cover T and sum to "
          f"{recorded_sweeps(st['scheme'])}; (a) sharded ingest weights bitwise = ingest_device's "
          f"(maxlet kernels at dim {st['dim']}); (b) graphed and eager sharded_phase engines "
          f"byte-identical (marginals, parameters, compression; sha256 {st['sha256']}); (e) every "
          f"sweep a CUDA graph replay (captures per phase {st['captures']}; kinds, graphs, capture "
          f"seconds {st['graphs']}), no plain version called, launches {st['launches']}; phases "
          f"{st['phases']}, eager {st['eager_phases']}; settled F {st['settled_iters']} 4 {rates} "
          f"sweeps/s (median {np.median(rates):.2f}, spread {min(rates):.2f}-{max(rates):.2f}) "
          f"vs this run's P=1 [{st['tag']}] median {np.median(p1_rates):.2f} "
          f"({np.median(rates) / np.median(p1_rates):.3f}x); settled capacity per shard "
          f"{st['cap_local']}; the sweep's cross-shard scan calls {st['cross_bitwise']} of 2 "
          f"bitwise; phase {st['seconds']:.1f} s", flush=True)


def kernel_label(mangled: str) -> str:
    """A kernel's name and template argument from its mangled symbol:
    _Z29fbscan_prefix_team_one_kernelILi9EEv... -> fbscan_prefix_team_one_kernel<9>."""
    import re

    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    end = m.end() + int(m.group(1))
    name, arg = mangled[m.end():end], re.match(r"ILi(\d+)E", mangled[end:])
    return name + (f"<{arg.group(1)}>" if arg else "")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == [PROFILE_FLAG]:
        return profile_transform()
    if sys.argv[1:2] == [CHAINS_FLAG]:
        return chains_across_cards(*map(int, sys.argv[2:4]))
    if sys.argv[1:2] == [TURNS_FLAG]:
        return measure_turns(int(sys.argv[2]))
    if sys.argv[1:2] == [STATES625_FLAG]:
        return states625_child(sys.argv[2])
    if sys.argv[1:2] == [CARDS_FLAG]:
        try:
            return sharded_cards(*map(int, sys.argv[2:5]))
        except SmokeFailure as exc:
            print(f"chip_smoke FAILED: {exc}", flush=True)
            return 1
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    seconds: dict = {}  # phase -> wall seconds, for the [time] line
    last = [time.perf_counter()]

    def took(phase: str) -> None:
        now = time.perf_counter()
        seconds[phase] = round(now - last[0], 1)
        last[0] = now

    print(f"[card] {smi} | torch {torch.__version__} (cuda {torch.version.cuda}) | "
          f"{name} x{torch.cuda.device_count()}", flush=True)

    try:
        with ThreadPoolExecutor(3) as pool:  # one nvcc per source, started together
            builds = list(pool.map(lambda module: module.build(), (wavelet_cuda, fb_cuda, model_cuda)))
        for tag, built in zip(("maxlet", "fbscan", "modelupdate"), builds):
            ptxas = [ln.strip() for ln in built.log.splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"[build] {tag} {built.path.name} in {built.seconds:.2f} s; "
                  + " | ".join(ptxas), flush=True)
        took("build")

        # first, while no engine of this process holds the card
        s625 = run_states625()
        took("states625")
        print_states625(s625)

        k = phase_kernel()
        took("kernel")
        print(f"[kernel] maxlet_chunk_kernel and maxlet_cross_kernel bitwise equal to "
              f"their plain versions, and maxlet_transform_cuda to wavelet.maxlet_transform, "
              f"on the card and the CPU at T in {KERNEL_SIZES} x dim in {KERNEL_DIMS} and on "
              f"the card at T={T_LARGE} dim=1; both kernels bitwise equal to "
              f"golden.reference.maxlet_transform at T={T_MAIN} dim 1 and 3 (max abs error "
              f"{k['worst']['golden']}); NaN propagates; one transform call ran "
              f"{k['profiled']} CUDA kernels (torch.profiler, child process)", flush=True)
        for (T, dim), row in k["timed"].items():
            print(f"[kernel] T={T} dim={dim}, ms with L2 flushed / warm, device only / "
                  f"warm with the host launch (least time on the card, its share of the "
                  f"flushed time): " + "; ".join(
                      f"{key} {row[key]:.4f} / {row[key + '_warm_device']:.4f} / "
                      f"{row[key + '_warm']:.4f} (bound "
                      f"{row[key + '_bound']:.4g} by {row[key + '_bound_by']}, "
                      f"{row[key + '_bound'] / row[key]:.1%}), plain "
                      f"{row[key + '_plain']:.4f} / {row[key + '_plain_warm_device']:.4f} / "
                      f"{row[key + '_plain_warm']:.4f}"
                      for key in ("chunk", "cross", "transform"))
                  + (f"; chunk through the scalar-load instance {row['chunk_scalar']:.4f} "
                     "flushed" if "chunk_scalar" in row else ""), flush=True)

        fbk = phase_fbscan()
        took("fbscan")
        print(f"[fbscan] prefix_matmul_scan_kernel within rtol {FB_RTOL} / atol {FB_ATOL} of "
              f"its plain version in all {fbk['cases']} cases (B in {FB_SIZES} x K in {FB_KS} x R "
              f"in {FB_ROWS}, at K = 17-32 (B, R) in {FB_WIDE_SHAPES}, at K = 33-64 in "
              f"{FB_DEEP_SHAPES} and K = 64 at ({FB_BIG}, 1), (K, B, R) in {FB_TILED_CASES}; "
              f"{fbk['subnormal_cases']} with 40 % zeros and 5 % subnormals (at K > 32 also 1 % -0) "
              f"or an infinity (K > 64), and the views; bitwise at every K > 32, one tiled-product "
              f"kernel per K = 33-64 call and one tiled kernel with j streamed per K > 64 call, "
              f"three suffix kernels per grouped K > 64 call, no generic kernel in the library "
              f"({', '.join(FB_GENERIC)}); {fbk['bitwise']} of "
              "them bitwise; largest absolute error "
              f"{fbk['prefix_err']}, relative {fbk['worst_rel']:.3g}); suffix_compose_scan_kernel "
              "bitwise equal to its plain version in all of them; each row of a 4-row call "
              "bitwise equal to its one-row call; permuted and transposed views against the plain "
              "versions of their contiguous copies (one of the cases); NaN propagates as in the "
              "plain version", flush=True)

        print(f"[fbscan] the sharded sweep's cross-shard calls at K > 3, P = B shards: the (K, K, "
              f"B) view of B shard totals and the (K, B) view of their maps, and their contiguous "
              f"copies, at (B, K) in {FB_CROSS_CASES}, against their plain versions (prefix "
              f"bitwise at K > 32, suffix bitwise; counted above); CUDA kernels per call "
              f"(contiguous) {fbk['cross']}", flush=True)

        mdk = phase_model()
        took("model")
        print(f"[model] the statistics kernel (modelupdate_stats_kernel, one cooperative launch) "
              f"bitwise equal to its plain version in all "
              f"{mdk['cases']} cases ((R, B) in {MODEL_ROWS} x K in {MODEL_KS} x dim in "
              f"{MODEL_DIMS}, at B=29696 also a masked tail and B+1 blocks; largest absolute "
              f"error {mdk['stats_err']}), each row of a 4-row call bitwise equal to its one-row "
              f"call; above K = 64 at (R, B, K, dim, P) in {MODEL_LARGE_K + MODEL_HUGE_K}, and "
              f"the sharded M "
              f"burn-in's rows at {MODEL_SHARDED_ROWS} (B > 262,144 against the plain version's "
              f"sums in chunks of 65,536 blocks); modelupdate_resample_kernel "
              f"bitwise equal to its plain version in {mdk['draws']} draws at K in "
              f"{MODEL_KS + MODEL_RESAMPLE_KS} with Gamma shapes 0.5-1e7 (largest "
              f"absolute error {mdk['resample_err']}); NaN statistics propagate as in the plain "
              "versions", flush=True)

        m = phase_main_path()
        took("main")
        print(f"[main] T={T_MAIN} K=3 '{SCHEME}': setup {m['setup_s']:.3f} s, "
              f"total {m['total_s']:.3f} s, F-phase {m['f_sweeps_per_s']:.2f} sweeps/s, "
              f"capacity {m['capacity']}, last blocks {m['last_n_blocks']}, "
              f"peak device memory {m['peak_mem_bytes'] / 2**20:.1f} MiB, "
              f"MAP agreement {m['map_agreement']:.4f}, maxlet launches "
              f"{m['launches']}, phases {m['phases']}; every sweep a CUDA graph replay "
              f"({m['captures']} captures, {m['capture_s']:.3f} s); sha256 of the marginals and "
              f"parameters files {m['sha256']}", flush=True)

        fb = fb_golden()
        took("golden")
        print(f"[main] FB sampler on the card vs golden.reference.fb_gibbs_sweep: "
              f"{fb['blocks']} blocks x {fb['draws']} draws each, per-block state frequencies "
              f"within the Monte-Carlo bound (largest share used {fb['share_of_bound']:.3f})",
              flush=True)

        main_eng = m.pop("engine")
        st = phase_settled(main_eng)
        took("settled")
        print(f"[settled] T={T_MAIN} F {SETTLED_ITERS} 4 on the [main] engine (capacity "
              f"{st['capacity']}, {st['chunks']} chunks per all-streams phase), order "
              f"{' '.join(t[0] for t in SETTLED_ORDER)}: marginals+parameters+compression "
              f"{st['mpc_sweeps_per_s']} "
              f"sweeps/s; all streams, drain on its worker {st['all_sweeps_per_s']} sweeps/s "
              f"(ratio of medians {st['ratio']:.4f}, of the best {st['best_ratio']:.4f}; drain "
              f"{st['drain_ms']:.3f} ms per chunk on the worker, launching thread waited "
              f"{st['waited_ms_per_chunk']:.3f} ms per chunk); all streams, drain inline "
              f"{st['inline_sweeps_per_s']} sweeps/s (ratio of medians {st['inline_ratio']:.4f}, "
              f"of the best {st['inline_best_ratio']:.4f}; drain {st['inline_drain_ms']:.3f} ms "
              "per chunk)", flush=True)

        g = phase_graph()
        took("graph")
        print_graph(g)

        c = phase_cli(m["f_sweeps_per_s"])
        took("cli")
        print(f"[cli] T={T_MAIN} all 7 outputs '{SCHEME}': setup {c['setup_s']:.3f} s, "
              f"F-phase {c['f_sweeps_per_s']:.2f} sweeps/s all streams = "
              f"{c['ratio']:.3f}x the [main] rate (marginals+parameters+compression), "
              f"MAP agreement {c['map_agreement']:.4f}, maxlet launches "
              f"{c['launches']}, native formatters {c['native']}; stream checks passed",
              flush=True)

        phase_resume()
        took("resume")
        print(f"[resume] T={T_RESUME}: M 32 0 -> checkpoint -> restore into a graphed engine "
              "-> F 64 4 bitwise equal to the uninterrupted run, graphed and eager (counts, "
              "emission means); every sweep a CUDA graph replay", flush=True)

        phase_debug()
        print("[debug] HAMMLET_DEBUG=1: healthy F chunk error bits 0; NaN emission "
              "mean raised FloatingPointError", flush=True)

        sh = phase_sharded(main_eng)
        took("sharded")
        print_sharded(sh, m["f_sweeps_per_s"])

        with tempfile.TemporaryDirectory() as tmp:
            s9 = phase_states9(tmp)
            took("states9")
        print_tracks("states9", s9, "configuration 4", "C 3 2", CONFIG4_T)
        with tempfile.TemporaryDirectory() as tmp:
            s27 = phase_states27(tmp)
            took("states27")
        print_tracks("states27", s27, "three tracks", "C 3 3", STATES27_CLI_T)
        with tempfile.TemporaryDirectory() as tmp:
            s64 = phase_states64(tmp)
            took("states64")
        print_tracks("states64", s64, "three tracks of four levels", "C 4 3", STATES64_CLI_T)
        with tempfile.TemporaryDirectory() as tmp:
            s81 = phase_states81(tmp)
            took("states81")
        print_tracks("states81", s81, "four tracks of three levels", "C 3 4", STATES81_CLI_T)

        tracks_p1 = {"states9": s9, "states27": s27, "states64": s64, "states81": s81}
        sht = {}
        for case in sharded_tracks_cases():
            with tempfile.TemporaryDirectory() as tmp:
                sht[case[2]] = phase_sharded_tracks(tmp, *case)
            print_sharded_tracks(sht[case[2]], tracks_p1[case[0]]["settled"])
        took("sharded_tracks")

        with tempfile.TemporaryDirectory() as tmp:
            ct = phase_cli_tracks(tmp)
        took("cli_tracks")
        print_cli_tracks(ct)

        sweep_p1, views_p1 = g["scans"].main_and_others()
        sweep_p4, views_p4 = sh.pop("scans").main_and_others()
        check(sorted((k, v.shape[-1]) for k, v in views_p4)
              == [("prefix", P_SHARDED), ("suffix", P_SHARDED)],
              f"[fbscan] the eager P={P_SHARDED} sweep's scan calls besides the local ones "
              f"were {[(k, tuple(v.shape)) for k, v in views_p4]}, not the two cross-shard ones")
        bitwise_views = check_cross_shard(views_p1 + views_p4)
        fbt = time_fbscan({
            "P=1 sweep data": sweep_p1,
            f"P={P_SHARDED} sweep data": sweep_p4,
            "P=1 uniform": fb_inputs(m["capacity"], 3, 1, SEED),
            f"P={P_SHARDED} uniform": fb_inputs(sh["cap_local"], 3, P_SHARDED, SEED),
            "T=250M per shard uniform": fb_inputs(FB_BIG, 3, 1, SEED),
            "flat uniform": fb_inputs(FB_FLAT, 3, 1, SEED),
            "K=9 sweep data": s9["scans"].main_and_others()[0],
            "K=9 uniform": fb_inputs(m["capacity"], 9, 1, SEED),
            "K=10 uniform": fb_inputs(m["capacity"], 10, 1, SEED),
            "K=16 uniform": fb_inputs(m["capacity"], 16, 1, SEED),
            "K=27 sweep data": s27["scans"].main_and_others()[0],
            "K=17 uniform": fb_inputs(m["capacity"], 17, 1, SEED),
            "K=27 uniform": fb_inputs(m["capacity"], 27, 1, SEED),
            "K=32 uniform": fb_inputs(m["capacity"], 32, 1, SEED),
            "K=64 sweep data": s64["scans"].main_and_others()[0],
            **{f"K={K} uniform": fb_inputs(m["capacity"], K, 1, SEED) for K in (33, 36, 48, 64)},
            "K=81 sweep data": s81["scans"].main_and_others()[0],
            **{f"K={K} uniform": fb_inputs(m["capacity"], K, 1, SEED) for K in (81, 128)},
            **{f"K={K} uniform": fb_inputs(B, K, 1, SEED) for K, B in FB_HUGE_TIMED.items()},
            **{f"K={K} P={P_SHARDED} sweep data": st.pop("scans") for K, st in sht.items()},
        })
        print(f"[fbscan] the sweep's own cross-shard calls ({len(views_p4)} of the eager "
              f"P={P_SHARDED} sweep, (kind, shape, strides) "
              f"{[(k, tuple(v.shape), v.stride()) for k, v in views_p4]}) against the plain "
              f"versions of their contiguous copies: {bitwise_views} of "
              f"{len(views_p1 + views_p4)} bitwise", flush=True)
        for tag, row in fbt.items():
            B, K, R = row["shape"]
            print(f"[fbscan] {tag} B={B} K={K} R={R}: kernels against their plain versions on "
                  f"these inputs (prefix bitwise {row['bitwise']}, suffix bitwise); CUDA kernels "
                  f"per call: prefix {row['prefix_kernels']}, suffix {row['suffix_kernels']}; ms "
                  "with L2 flushed / warm, device only (least time on the card, its share of the "
                  "flushed time): " + "; ".join(
                      f"{key} kernels {row[key]:.4f} / {row[key + '_warm']:.4f} (bound "
                      f"{row[key + '_bound']:.4g} by {row[key + '_bound_by']}, "
                      f"{row[key + '_bound'] / row[key]:.1%}), plain {row[key + '_plain']:.4f} / "
                      f"{row[key + '_plain_warm']:.4f}, PyTorch call: none"
                      for key in ("prefix", "suffix")), flush=True)
        for tag in FB_ONE_LAUNCH:
            for key in ("prefix", "suffix"):
                check(len(fbt[tag][key + "_kernels"]) == 1,
                      f"[fbscan] one {key} scan call on the {tag} inputs ran "
                      f"{fbt[tag][key + '_kernels']}, not one CUDA kernel")
        for tag, row in fbt.items():
            B, K, R = row["shape"]
            if K > 64:
                prefix = [n for n, _ in row["prefix_kernels"]]
                check(len(prefix) == 1 and FB_TILED[0] in prefix[0],
                      f"[fbscan] a K = {K} prefix call on the {tag} inputs ran {prefix}, not one "
                      "tiled kernel with j streamed")
                suffix = [n for n, _ in row["suffix_kernels"]]
                check(suffix_grouped(K, suffix),
                      f"[fbscan] a K = {K} suffix call on the {tag} inputs ran {suffix}, not the "
                      "grouped form")
            if 32 < K <= 64:
                prefix = [n for n, _ in row["prefix_kernels"]]
                check(len(prefix) == 1 and FB_DEEP[0] in prefix[0],
                      f"[fbscan] a K = {K} prefix call on the {tag} inputs ran {prefix}, not one "
                      "tiled-product kernel")
                check("uniform" not in tag or len(row["suffix_kernels"]) == 1
                      and "fbscan_suffix_one_kernel" in row["suffix_kernels"][0][0],
                      f"[fbscan] a K = {K} suffix call on the {tag} inputs ran "
                      f"{row['suffix_kernels']}, not one CUDA kernel")
            if 16 < K <= 32:
                prefix = [n for n, _ in row["prefix_kernels"]]
                check(len(prefix) == 3 and all(w in n for w, n in zip(FB_WIDE, prefix)),
                      f"[fbscan] a K = {K} prefix call on the {tag} inputs ran {prefix}, not "
                      "the wide instances")
                check(len(row["suffix_kernels"]) == 1
                      and "fbscan_suffix_one_kernel" in row["suffix_kernels"][0][0],
                      f"[fbscan] a K = {K} suffix call on the {tag} inputs ran "
                      f"{row['suffix_kernels']}, not one CUDA kernel")
        print(f"[fbscan] K=10 B={m['capacity']}, ms with L2 flushed: prefix "
              f"{fbt['K=10 uniform']['prefix']:.4f}, suffix {fbt['K=10 uniform']['suffix']:.4f}; "
              f"the generic kernels they replaced took {FB_GENERIC_K10_MS['prefix']} and "
              f"{FB_GENERIC_K10_MS['suffix']} "
              f"({FB_GENERIC_K10_MS['prefix'] / fbt['K=10 uniform']['prefix']:.1f}x and "
              f"{FB_GENERIC_K10_MS['suffix'] / fbt['K=10 uniform']['suffix']:.2f}x)", flush=True)
        k27 = fbt["K=27 uniform"]
        print(f"[fbscan] K=27 B={m['capacity']}, ms with L2 flushed: prefix {k27['prefix']:.4f} "
              f"(the sweep's own {fbt['K=27 sweep data']['prefix']:.4f}), suffix "
              f"{k27['suffix']:.4f}; the generic kernels they replaced took "
              f"{FB_GENERIC_K27_MS['prefix']} and {FB_GENERIC_K27_MS['suffix']} "
              f"({FB_GENERIC_K27_MS['prefix'] / k27['prefix']:.1f}x and "
              f"{FB_GENERIC_K27_MS['suffix'] / k27['suffix']:.2f}x); K=17 prefix "
              f"{fbt['K=17 uniform']['prefix']:.4f}, K=32 {fbt['K=32 uniform']['prefix']:.4f}",
              flush=True)
        deep = []
        for K in (33, 36, 48, 64):
            row, old = fbt[f"K={K} uniform"], FB_GENERIC_DEEP_MS.get(K)
            deep.append(
                f"K={K} prefix {row['prefix']:.4f} (bound {row['prefix_bound']:.4g}, "
                f"{row['prefix_bound'] / row['prefix']:.1%}), suffix {row['suffix']:.4f}"
                + (f"; the generic kernels took {old['prefix']} and {old['suffix']} "
                   f"({old['prefix'] / row['prefix']:.1f}x and {old['suffix'] / row['suffix']:.2f}x)"
                   if old else ""))
        own = fbt["K=64 sweep data"]
        print(f"[fbscan] K=33-64 B={m['capacity']} (the tiled products, one launch), ms with L2 "
              f"flushed: {'; '.join(deep)}; the K=64 sweep's own at B={own['shape'][0]}: prefix "
              f"{own['prefix']:.4f}, suffix {own['suffix']:.4f}", flush=True)
        over = []
        for K in (81, 128):
            row, old = fbt[f"K={K} uniform"], FB_GENERIC_OVER64_MS.get(K)
            over.append(
                f"K={K} prefix {row['prefix']:.4f} (bound {row['prefix_bound']:.4g}, "
                f"{row['prefix_bound'] / row['prefix']:.1%}; plain {row['prefix_plain']:.4f}), "
                f"suffix {row['suffix']:.4f} (bound {row['suffix_bound']:.4g})"
                + (f"; the generic kernels took {old['prefix']} and {old['suffix']} "
                   f"({old['prefix'] / row['prefix']:.1f}x and {old['suffix'] / row['suffix']:.2f}x)"
                   if old else ""))
        own = fbt["K=81 sweep data"]
        print(f"[fbscan] K>64 B={m['capacity']} (the tiled products with j streamed, one launch; "
              f"the grouped suffix, three), ms with L2 flushed: {'; '.join(over)}; the K=81 "
              f"sweep's own at B={own['shape'][0]}: prefix {own['prefix']:.4f}, suffix "
              f"{own['suffix']:.4f}", flush=True)
        huge = []
        for K in FB_HUGE_TIMED:
            row = fbt[f"K={K} uniform"]
            huge.append(f"K={K} B={row['shape'][0]} prefix {row['prefix']:.4f} (bound "
                        f"{row['prefix_bound']:.4g}, {row['prefix_bound'] / row['prefix']:.1%}; plain "
                        f"{row['prefix_plain']:.4f}), suffix {row['suffix']:.4f} (bound "
                        f"{row['suffix_bound']:.4g}; {[kernel_label(n) for n, _ in row['suffix_kernels']]})")
        print(f"[fbscan] K>512 (the tiled kernel with j streamed, its transposes taking a row in "
              f"pieces; one launch), ms with L2 flushed: {'; '.join(huge)}", flush=True)
        for P in (1, P_SHARDED):
            own, uni = fbt[f"P={P} sweep data"], fbt[f"P={P} uniform"]
            print(f"[fbscan] P={P}, ms with L2 flushed on the sweep's own inputs / on uniform "
                  f"inputs of the same shape (ratio): prefix {own['prefix']:.4f} / "
                  f"{uni['prefix']:.4f} ({own['prefix'] / uni['prefix']:.3f}x), suffix "
                  f"{own['suffix']:.4f} / {uni['suffix']:.4f} "
                  f"({own['suffix'] / uni['suffix']:.3f}x)"
                  + (f"; the three-launch prefix kernels took {FB_THREE_LAUNCH_PREFIX_MS} on the "
                     f"sweep's own, the bound is {own['prefix_bound']:.4g} ms" if P == 1 else ""),
                  flush=True)

        own_p1, own_p4 = g["models"].main(), sh.pop("models").main()
        mdt = time_model({
            "P=1 sweep data": own_p1,
            f"P={P_SHARDED} sweep data": own_p4,
            "T=4M burn-in uniform": (model_stats_inputs(1, T_MAIN, 3, 1, SEED), own_p1[1]),
            "T=250M per shard uniform": (model_stats_inputs(4, FB_BIG, 3, 1, SEED), own_p4[1]),
            "K=10 dim=3 uniform": (model_stats_inputs(1, m["capacity"], 10, 3, SEED),
                                   model_resample_inputs(10, SEED)),
            "K=9 dim=2 sweep data": s9["models"].main(),
            "K=27 dim=3 sweep data": s27["models"].main(),
            "K=64 dim=3 sweep data": s64["models"].main(),
            "K=81 dim=4 sweep data": s81["models"].main(),
            **{f"K={K} dim={st['dim']} P={P_SHARDED} sweep data": st.pop("models")
               for K, st in sht.items()},
        })
        mdt.update(time_model({  # above K = 512: the plain statistics take K^2 B floats
            f"K={K} dim={dim} uniform": (model_stats_inputs(R, B, K, dim, SEED, P=P),
                                         model_resample_inputs(K, SEED))
            for R, B, K, dim, P in (MODEL_HUGE_K[0], MODEL_HUGE_K[3])}, reps=3))
        for tag, row in mdt.items():
            R, B, K, dim = row["model_shape"]
            print(f"[model] {tag} R={R} B={B} K={K} dim={dim}: both kernels bitwise equal to their "
                  f"plain versions on these inputs; CUDA kernels per call: statistics "
                  f"{row['stats_kernels']}, resample {row['resample_kernels']}; ms with L2 flushed / "
                  "warm, device only (least time on the card, its share of the flushed time): "
                  + "; ".join(
                      f"{key} kernel {row[key]:.4f} / {row[key + '_warm']:.4f} (bound "
                      f"{row[key + '_bound']:.4g} by {row[key + '_bound_by']}, "
                      f"{row[key + '_bound'] / row[key]:.1%}"
                      + (f"; the kernels it replaced {MODEL_BEFORE_MS[key]}, "
                         f"{row[key] / MODEL_BEFORE_MS[key]:.3f}x" if tag == "P=1 sweep data" else "")
                      + f"), plain {row[key + '_plain']:.4f} / {row[key + '_plain_warm']:.4f}, "
                      "PyTorch call: none" for key in ("stats", "resample")), flush=True)
            check(len(row["stats_kernels"]) == 1
                  and "modelupdate_stats_kernel" in row["stats_kernels"][0][0],
                  f"[model] one statistics call on the {tag} inputs ran {row['stats_kernels']}, "
                  "not one CUDA kernel")
            check(len(row["resample_kernels"]) == 1
                  and "modelupdate_resample_kernel" in row["resample_kernels"][0][0],
                  f"[model] one resample call on the {tag} inputs ran {row['resample_kernels']}")
        kpc = model_kernels_per_call()
        took("timed fbscan and model")
        print(f"[model] one CUDA kernel per statistics call (modelupdate_stats_kernel) at all "
              f"{kpc['cases']} checked shapes, and per resample call at K in "
              f"{MODEL_KS + MODEL_RESAMPLE_KS}", flush=True)

        with tempfile.TemporaryDirectory() as tmp:
            ch = phase_chains(tmp)
            print(f"[chains] -M with two chromosomes of T={T_CHAIN} '{CHAIN_SCHEME}' in the order "
                  f"{' '.join(CHAIN_ORDER)}: two threads on cuda:0 taking turns at phases "
                  f"{ch['threads_s']} s, without turns {ch['free_s']} s, one after another "
                  f"{ch['sequential_s']} s (sequential / threaded ratio of medians "
                  f"{ch['ratio']:.3f}, without turns {ch['free_ratio']:.3f}); marginals, "
                  f"parameters and compression byte-identical; every chain's sweeps CUDA graph "
                  f"replays; maxlet launches in the first threaded run {ch['threads_launches']}; "
                  "both kernels bitwise equal to their plain versions on each chain's data, on "
                  "the card and the CPU", flush=True)
            tl = phase_tools(ch["prefix"])
            took("chains and tools")
            print(f"[tools] bin/hammlet-torch-max-segmentation ({tl['segments']} segments, "
                  f"covers T, = in-process) and bin/hammlet-torch-sort-states ({tl['means']}) "
                  f"on chain 1 in subprocesses without JAX; seconds {tl['seconds']}", flush=True)

        pr = phase_profile(main_eng, sh.pop("engine"), sh.pop("eager_engine"),
                           {"states9": s9.pop("engines"), "states27": s27.pop("engines"),
                            "states64": s64.pop("engines"), "states81": s81.pop("engines")},
                           {K: st.pop("engine") for K, st in sht.items()})
        took("profile")
        for K, st in sht.items():
            seen = check_sharded_tracks_profile(st, pr[f"sharded{K}"])
            p = pr[f"sharded{K}"]
            print(f"[sharded_tracks] K={K} (f) graphed P={P_SHARDED} engine under torch.profiler, "
                  f"per settled sweep of F 64 4: hand-written kernels {seen}, expected from the "
                  f"sweep's own calls {st['expected_per_sweep']}; no plain version, no generic "
                  f"kernel; launch calls {p['launch_calls']}, {p['kernels']} device kernels, "
                  f"{p['device_ms']:.4f} device ms summed, {p['busy_ms']:.4f} as the union of "
                  f"their intervals, {p['wall_ms']:.4f} wall ms (busy {p['busy']:.1%} under the "
                  f"profiler); costliest kernels {p['top']}; FB scan kernels (per sweep, device ms "
                  f"per sweep) {p['fbscan']}; model-update kernels {p['model']}", flush=True)
        print(f"[profile] torch.profiler F 64 4 at T={T_MAIN}: [main] engine HAMMLET_DEBUG "
              f"off {pr['0'][0]} kernels/sweep, {pr['0'][1]:.4f} device ms/sweep; on "
              f"{pr['1'][0]} kernels/sweep, {pr['1'][1]:.4f} device ms/sweep; [sharded] "
              f"engine (P={P_SHARDED}) {pr['sharded'][0]} kernels/sweep, "
              f"{pr['sharded'][1]:.4f} device ms/sweep", flush=True)
        for tag in ("graph", "eager", "sharded_graph", "sharded_eager"):
            p = pr[tag]
            what = (f"{tag[8:]} [sharded] engine (P={P_SHARDED})" if tag.startswith("sharded")
                    else f"{tag} [main] engine")
            print(f"[profile] {what}, per settled sweep of F 64 4: launch calls "
                  f"{p['launch_calls']}, {p['kernels']} device kernels, {p['device_ms']:.4f} device "
                  f"ms summed, {p['busy_ms']:.4f} as the union of their intervals, "
                  f"{p['wall_ms']:.4f} wall ms under the profiler (busy {p['busy']:.1%}); "
                  f"costliest kernels (name, per sweep, device ms per sweep) {p['top']}; FB scan "
                  f"kernels (per sweep, device ms per sweep) {p['fbscan']}; model-update kernels "
                  f"{p['model']}", flush=True)
        for tag, K, dim, kind in (("states9", STATES9_K, 2, "team"),
                                  ("states27", STATES27_K, 3, "wide"),
                                  ("states64", STATES64_K, 3, "tiled-product"),
                                  ("states81", STATES81_K, 4, "tiled with j streamed")):
            p = pr[tag]
            print(f"[profile] graphed [{tag}] engine (K={K}, dim {dim}), per settled sweep of F 64 "
                  f"4: launch calls {p['launch_calls']}, {p['kernels']} device kernels, "
                  f"{p['device_ms']:.4f} device ms summed, {p['busy_ms']:.4f} as the union of their "
                  f"intervals, {p['wall_ms']:.4f} wall ms (busy {p['busy']:.1%} under the "
                  f"profiler); costliest kernels {p['top']}; FB scan kernels (per sweep, device ms "
                  f"per sweep) {p['fbscan']} ({kind} instances); model-update "
                  f"kernels {p['model']}; eager [{tag}] sweep's device ms per sweep by stage "
                  f"({pr[tag + '_split']['total_ms']:.4f} ms in all): {pr[tag + '_split']['stages']}",
                  flush=True)
        walls = {t: 1e3 / float(np.median(g["settled"][t])) for t in ("graph", "eager")}
        print(f"[profile] wall ms per sweep without the profiler ([graph] settled medians) "
              f"against the union of the kernels' intervals under it: graphed "
              f"{walls['graph']:.4f} vs {pr['graph']['busy_ms']:.4f} ms "
              f"({pr['graph']['busy_ms'] / walls['graph']:.1%}; over 100 % where the profiler "
              f"lengthens the kernels), eager {walls['eager']:.4f} vs {pr['eager']['busy_ms']:.4f} "
              f"ms ({pr['eager']['busy_ms'] / walls['eager']:.1%}); "
              f"eager sweep's device ms per sweep by the stage that launched it (record_function "
              f"ranges, {pr['split']['total_ms']:.4f} ms in all): {pr['split']['stages']}; CUDA "
              f"kernels per sweep of the model update's stages {pr['split']['model_stages']}",
              flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", flush=True)
        return 1

    print(f"[time] wall seconds per phase {seconds}, {sum(seconds.values()):.1f} in all",
          flush=True)
    # the main path's inputs
    main_row = {**k["timed"][(T_MAIN, 1)], **fbt["P=1 sweep data"], **mdt["P=1 sweep data"]}
    worst = {"chunk": max(k["worst"]["chunk"], k["worst"]["golden"], ch["worst"]["chunk"]),
             "cross": max(k["worst"]["cross"], k["worst"]["golden"], ch["worst"]["cross"]),
             "prefix": fbk["prefix_err"], "suffix": fbk["suffix_err"],
             "stats": mdk["stats_err"], "resample": mdk["resample_err"]}
    per_sweep = {**pr["graph"]["fbscan"], **pr["graph"]["model"]}
    print(json.dumps({"kernels": [{
        "name": kernel,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": m["launches"][count] + c["launches"][count] + ch["threads_launches"][count],
        # the CUDA kernels per settled graphed P = 1 sweep ([profile]); the maxlet
        # kernels run once per ingest, in no sweep
        "device_launches_per_sweep": (
            sum(n for name, (n, _) in per_sweep.items()
                if ("fbscan_" if key in ("prefix", "suffix") else "modelupdate_") + key in name)
            if key in ("prefix", "suffix", "stats", "resample") else None),
        "max_abs_err": worst[key],
        "ms": main_row[key],
        "plain_ms": main_row[key + "_plain"],
        "bound_ms": main_row[key + "_bound"],
        "bound_by": main_row[key + "_bound_by"],
        # no single PyTorch call computes the maxlet transform, either scan, the sweep
        # statistics or the resample
        "library_ms": None,
    } for kernel, source, replaces, key, count in KERNEL_ROWS] + [{
        # the scan kernels of [states9] (K = 9: the team prefix), [states27] (K = 27: the wide
        # prefix's three), [states64] (K = 64: the tiled product) and [states81] (K = 81: the
        # tiled product with j streamed; the grouped suffix's three), timed on each sweep's own
        # matrices and maps
        "name": " + ".join(kernel_label(n) for n, _ in fbt[f"K={K} sweep data"][key + "_kernels"]),
        "route": "cuda",
        "source": "hammlet_tpu_torch/csrc/fbscan.cu",
        "replaces": replaces,
        "launches": phase["graph"]["launches"][count],
        "device_launches_per_sweep": sum(n for kname, (n, _) in pr[tag]["fbscan"].items()
                                         if "fbscan_" + key in kname),
        "max_abs_err": worst[key],
        "ms": fbt[f"K={K} sweep data"][key],
        "plain_ms": fbt[f"K={K} sweep data"][key + "_plain"],
        "bound_ms": fbt[f"K={K} sweep data"][key + "_bound"],
        "bound_by": fbt[f"K={K} sweep data"][key + "_bound_by"],
        "library_ms": None,
    } for tag, K, phase in (("states9", STATES9_K, s9), ("states27", STATES27_K, s27),
                            ("states64", STATES64_K, s64), ("states81", STATES81_K, s81))
      for _, _, replaces, key, count in KERNEL_ROWS if key in ("prefix", "suffix")] + [{
        # the sweep's kernels in [sharded_tracks] (P = 4 shards on one card, K = 9, 27, 64, 81),
        # timed on each sharded sweep's own inputs
        "name": (" + ".join(kernel_label(n) for n, _ in row[key + "_kernels"])
                 if key in ("prefix", "suffix") else kernel),
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sht[K]["launches"][count],
        "device_launches_per_sweep": sum(
            n for kname, (n, _) in {**pr[f"sharded{K}"]["fbscan"], **pr[f"sharded{K}"]["model"]}.items()
            if ("fbscan_" if key in ("prefix", "suffix") else "modelupdate_") + key in kname),
        "max_abs_err": worst[key],
        "ms": row[key],
        "plain_ms": row[key + "_plain"],
        "bound_ms": row[key + "_bound"],
        "bound_by": row[key + "_bound_by"],
        "library_ms": None,
    } for K in sht for kernel, source, replaces, key, count in KERNEL_ROWS
      if key in ("prefix", "suffix", "stats", "resample")
      for row in ([fbt[f"K={K} P={P_SHARDED} sweep data"]] if key in ("prefix", "suffix")
                  else [mdt[f"K={K} dim={sht[K]['dim']} P={P_SHARDED} sweep data"]])] + [{
        # [cli_tracks]: the maxlet kernels at dim 3 on (c)'s -M inputs (device ingest), and the
        # sweep's kernels in an F sweep right after a prior draw at capacity ~T or at the ceiling
        # ((e)), checked and timed on that sweep's own inputs; the launches are the whole path's
        "name": (" + ".join(kernel_label(n) for n, _ in row[key + "_kernels"])
                 if key in ("prefix", "suffix") else kernel),
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": ct["launches"][count],
        "device_launches_per_sweep": None,
        "max_abs_err": ct["maxlet"]["worst"][key] if key in ("chunk", "cross") else row[key + "_err"],
        "ms": row[key],
        "plain_ms": row[key + "_plain"],
        "bound_ms": row[key + "_bound"],
        "bound_by": row[key + "_bound_by"],
        "library_ms": None,
    } for kernel, source, replaces, key, count in KERNEL_ROWS
      for row in ([ct["maxlet"]] if key in ("chunk", "cross") else
                  list(ct["fbscan"].values()) if key in ("prefix", "suffix") else
                  list(ct["model"].values()))] + [{
        # [states625] (K = 625, in a process of its own): the maxlet kernels at dim 4 on its data,
        # the sweep's kernels on its own inputs (the prefix, and its plain version, on their first
        # STATES625_CHECK_B blocks); the launches are the graphed engine's path's
        "name": (" + ".join(kernel_label(n) for n, _ in row[key + "_kernels"])
                 if key in ("prefix", "suffix") else kernel),
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": s625["graph"]["launches"][count],
        "device_launches_per_sweep": None,
        "max_abs_err": (s625["maxlet"]["worst"][key] if key in ("chunk", "cross")
                        else row.get(key + "_err", 0.0)),
        "ms": row[key],
        "plain_ms": row[key + "_plain"],
        "bound_ms": row[key + "_bound"],
        "bound_by": row[key + "_bound_by"],
        "library_ms": None,
    } for kernel, source, replaces, key, count in KERNEL_ROWS
      for row in [{"chunk": s625["maxlet"], "cross": s625["maxlet"], "prefix": s625["sweep"]["part"],
                   "suffix": s625["sweep"]["whole"]}.get(key, s625["sweep"]["model"])]]}),
          flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
