#!/usr/bin/env python3
"""Card probes of the FB scan kernels (csrc/fbscan.cu) and the model-update
kernels (csrc/modelupdate.cu) beyond chip_smoke.py.

    python3 fbscan_probes.py t250 N T SETTLED TURNS
        chip_smoke.py's [cards] (d) (T positions of BigData, BIG_SCHEME, -D N
        over N cards, one process per card), then TURNS settled
        ``F SETTLED 4`` phases on the same engine and torch.profiler over
        F 16 4 on rank 0. Prints one line "T250 <json>": setup seconds, the
        scheme's phases and their captures, the settled sweeps/s, kernels
        and device ms per sweep and the costliest kernels. To compare two
        trees, copy this file into the root of each (e.g. the parent
        unpacked with ``git archive``) and run it there in turns.

    python3 fbscan_probes.py turns OLD_CU [OTHER_CU ...]
        Each source is an FB scan source (fbscan.cu) or, where it defines
        hammlet_sweep_stats, a model-update source (modelupdate.cu). The
        first of each kind is the parent's (e.g. ``git show HEAD~1:
        hammlet_tpu_torch/csrc/fbscan.cu`` written to a git-ignored file).
        FB scan sources are built beside the current fbscan.cu, at every
        timed input of chip_smoke.py's [fbscan]: the sweep's own matrices
        and maps at P = 1 and P = 4 (taken from eager engines at T = 4M),
        uniform inputs at those shapes, B = 433,920, a flat B = 500,000 and
        K = 10. On each input each library is checked against the plain
        versions (prefix bitwise, suffix equal), its CUDA kernels per call
        are counted, and both scans are timed with L2 flushed, the libraries
        in turns (old, current, others, others reversed, current, old).
        Prints one line "TURNS <json>" per input. Model-update sources are
        built beside the current modelupdate.cu, at every timed input of
        chip_smoke.py's [model]: the statistics and resample calls of the
        same eager engines at P = 1 and P = 4, uniform statistics at T =
        4M's burn-in capacity, four rows of T = 250M's per-shard capacity
        and K = 10 dim 3; on each, each library's statistics and resample
        kernels are checked bitwise against their plain versions and
        counted per call, and both are timed with L2 flushed in the same
        turns. Prints one line "MODEL_TURNS <json>" per input.

    python3 fbscan_probes.py teams OLD_FBSCAN_CU
        The team instances (K = 9..16) of the current fbscan.cu against the
        parent's source (which ran K > 8 on its generic kernels), in turns
        (old, current, current, old), on uniform inputs: K in TEAM_KS at B =
        29,696, B = 9,600 in four rows, B = 16,384 at K = 16 (128 groups),
        T = 250M's per-shard B = 433,920 and a flat B = 100,000 at K = 9 and
        16, sweep-like matrices (40 % zeros, 5 % subnormal) at K = 9, and
        K = 27 (generic in both). Prints the ptxas lines of the team kernels,
        then one line "TEAMS <json>" per input: each library checked
        against the plain versions (prefix bitwise, suffix equal), its CUDA
        kernels per call (symbol, CTAs), and both scans' times with L2
        flushed, beside the bound (chip_smoke.fb_work).

    python3 fbscan_probes.py wide OLD_FBSCAN_CU
        The wide instances (K = 17..32: a thread block cluster per group)
        of the current fbscan.cu, as `teams`, against the parent's source
        (which ran K > 16 on its generic kernels) in turns, on uniform
        inputs: K in WIDE_KS at B = 29,696 (33: generic in both), K = 27 at
        B = 9,600 in four rows, at a flat B = 100,000 and sweep-like, K =
        17, 27 and 32 at B = 433,920. Prints the ptxas lines of the wide
        group, team rows and combine and one-launch suffix kernels, one
        line "TEAMS <json>" per input, then each K = 17..33 against the
        plain versions at WIDE_BITS, at K = 27 also with zeros and
        subnormals and with a NaN (one line "WIDE_BITS <json>": the cases,
        and those not bitwise).

    python3 fbscan_probes.py deep OLD_FBSCAN_CU
        The tiled-product instances (K = 33..64) of the current fbscan.cu,
        as `teams`, against the parent's source (which ran K > 32 on its
        generic kernels) in turns, on uniform inputs: K in DEEP_KS at B =
        29,696, K = 64 at B = 9,600 in four rows and sweep-like. Prints the
        ptxas lines of the deep and suffix kernels and one line "TEAMS
        <json>" per input; then each K = 33..65 against the plain versions
        at WIDE_BITS, at K in DEEP_SPECIAL_KS also with zeros and
        subnormals, with -0 and an infinity, and with a NaN (one line
        "WIDE_BITS <json>"); then the tile shapes (DEEP_VARIANTS: two
        matrices per CTA, as built; one matrix per CTA; 16 x 16 threads per
        matrix), as `variants` at K in DEEP_KS.

    python3 fbscan_probes.py over64 OLD_FBSCAN_CU
        The tiled-product instances with j streamed (K > 64) of the current
        fbscan.cu, as `teams`, against the parent's source (which ran K > 64
        on its generic kernels, and the grouped suffix above 64 flat over
        the card) in turns, on uniform inputs: K = 81 and 128 at B =
        29,696, K = 160 and 243 at B = 2,944 (OVER64_INPUTS); then each K of
        OVER64_BITS_KS against the plain versions at WIDE_BITS (above
        4,096 blocks only up to K = 128), at OVER64_SPECIAL_KS also with zeros and
        subnormals, with -0 and an infinity, and with a NaN ("WIDE_BITS");
        then the slab and register variants (OVER64_VARIANTS), as
        `variants` at K in OVER64_VARIANT_KS at B = 29,696; last the
        current kernels alone at K = 96, 160 and 243, B = 29,696 (one line
        "ALONE <json>" each: both scans' times with L2 flushed beside the
        bound, the CUDA kernels per call, and at K = 96 and 160 the plain
        versions' times, one call each). Its output is long: send it to a
        file.

    python3 fbscan_probes.py variants KS SUBSTITUTIONS
        Copies of the current fbscan.cu, each with text substituted
        (SUBSTITUTIONS: JSON {name: [[old, new], ...]}; an empty list is
        the source as it is), instantiated for K >= min(KS) only and built
        side by side; prints each copy's ptxas lines of the wide, team rows
        and combine and one-launch suffix kernels and its build seconds,
        then for each K of KS (comma-separated) at B = 29,696 and 433,920
        one line "VARIANTS <json>": each copy checked against the plain
        versions (prefix bitwise, suffix equal), its CUDA kernels per call
        and both scans' times with L2 flushed, the copies in turns (in
        order, then reversed).

    python3 fbscan_probes.py team_stamps [SOURCE ...]
        Where the one-launch team kernel's time goes: a copy of each
        fbscan.cu (the current one when none is given), instantiated for K
        <= 10 only, with globaltimer stamps in
        fbscan_prefix_team_one_kernel (TEAM_STAMP_AT: entry, group loaded,
        in-group levels done, total written, the totals' grid-wide levels
        done, their scan at the CTA's position done, final combine done,
        stored), built beside it, at B =
        29,696 on uniform inputs, L2 flushed. Prints "TEAM_STAMPS <json>"
        per source and K: the call's time and, per stamp, microseconds
        after the first CTA's entry, [min, median, max] over the CTAs.

    python3 fbscan_probes.py stamps
        Where the statistics kernel's time goes: a copy of the current
        modelupdate.cu with globaltimer stamps at its phases (STAMP_AT:
        entry, staging started, tile staged, its blocks read, the group's
        leaves, the tree's levels, before and after the grid barrier, the
        outputs' trees, the end), built beside it, at the P = 1 capacity
        and at four rows of 433,920, warm and with L2 flushed; and beside
        them the floor of the timing: a kernel that does nothing (a plain
        launch of 29 CTAs) and one that only passes a grid barrier (a
        cooperative launch of 145). Prints "EMPTY ..." and one line
        "STAMPS <json>" per input and mode: microseconds after the first
        CTA's entry, [min, median, max] over the CTAs, per stamp.

    python3 fbscan_probes.py over512 OLD_FBSCAN_CU
        The tiled kernel with j streamed of the current fbscan.cu against
        the parent's (whose transposes took whole rows of matrices, and
        which refused K > 512) in turns (old, current, current, old) at K =
        81, 128 and 243, B = 29,696 (OVER512_TURNS): each library's prefix
        bitwise equal to the parent's, and both timed with L2 flushed
        (lines "OVER512_TURNS <json>"); then the current kernel alone at K =
        513, 625, 729 and 1024 (OVER512_ALONE: B = 384 and 4,096), its CUDA
        kernels per call and its time with L2 flushed beside the bound
        (lines "OVER512_ALONE <json>"). First the ptxas lines of the tiled
        kernels.

    python3 fbscan_probes.py prior_peak K [T]
        One F phase of 16 sweeps right after a prior draw, the first op of
        chip_smoke.py's [cli_tracks] (e), on [states9]-[states81]'s or
        [states625]'s data at K (9, 27, 64, 81 or 625) and T positions per
        track (400,000 by default), through runner.make_engine in this
        process, at the prior threshold's capacity. Prints one line "PRIOR_PEAK <json>": the capacity,
        seconds, the seconds its captures took, the device memory the
        engine held before the phase, the peak allocated above it, the peak
        reserved by the process, and the full text of an error. Runs on an
        older tree too (copy this file there), to compare the capture's
        memory of two trees in turns; tests/test_torch_cuda.py runs it at K
        = 81.

Needs one card (turns, stamps) or N (t250); imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from hammlet_tpu_torch import _build
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.parallel import distributed, launch, sharded
from hammlet_tpu_torch.parallel.mesh import position_mesh


def big(n: int, T: int, settled: int, turns: int) -> dict:
    """In each process of an n-process group: [cards] (d), then the
    settled phases and the profile (rank 0's result is returned)."""
    rank = torch.distributed.get_rank()
    dev = distributed.process_device()
    data = cs.BigData(T, cs.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        rec = Records(T, os.path.join(tmp, "big-"), ".csv", 3, outputs={"marginals"},
                      overwrite=True, write=rank == 0)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng = sharded.make_sharded_engine(data, mesh=position_mesh(n), T=T, dim=1, nr_params=3,
                                          seed=cs.SEED, records=rec)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        log = cs.log_captures(eng)
        eng.run_scheme(cs.BIG_SCHEME.split())
        eng.finalize()
        torch.cuda.synchronize(dev)
        scheme = [(m, k, round(s, 4)) for m, k, s in eng.phase_log]
        eng.records = None
        rates = []
        for _ in range(turns):
            eng.run("F", settled, 4)
            rates.append(settled / eng.phase_log[-1][2])
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize(dev)
        with prof:
            eng.run("F", 16, 4)
            torch.cuda.synchronize(dev)
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by: dict = {}
        for e in kern:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    return {"setup_s": setup_s, "scheme_phases": scheme, "captures": list(log),
            "cap_local": eng.cap_local, "settled_F": rates,
            "device_ms_per_sweep": sum(by.values()) / 16 / 1e3,
            "kernels_per_sweep": len(kern) / 16,
            "top": [(k[:80], round(v / 16 / 1e3, 4)) for k, v in top]}


def sweep_inputs() -> tuple[dict, dict]:
    """The sweep's own (M, maps) at P = 1 and P = P_SHARDED: the largest
    scan call of each kind of an eager engine's settled F sweeps at T_MAIN
    (chip_smoke.py's configuration); and the same sweeps' (statistics
    arguments, resample arguments) of their model update."""
    from hammlet_tpu_torch import runner

    data = cs.synth(cs.T_MAIN, cs.SEED)[0]
    got, models = {}, {}
    for P in (1, cs.P_SHARDED):
        if P == 1:
            eng = runner.make_engine(data, nr_params=3, seed=cs.SEED, device="cuda")
            cs.eager_engine(eng)
        else:
            eng = sharded.make_sharded_engine(data, n_devices=P, nr_params=3, seed=cs.SEED,
                                              device="cuda")
            cs.eager_sharded_engine(eng)
        eng.run_scheme(["M", "64", "0", "F", "64", "4"])
        with cs.ScanInputs() as scans, cs.ModelInputs() as model:
            eng.run("F", 4, 4)
        got[P], models[P] = scans.main_and_others()[0], model.main()
        del eng
    torch.cuda.empty_cache()
    return got, models


def sweep_like(B: int, lowest: float, zeros: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, K, 1, B) matrices like the sweep's, K = 3: A * exp(E - max E)
    with E down to ``lowest`` (below about -87.3 an entry is subnormal,
    below about -103.9 zero) and a share ``zeros`` of the entries under
    each column's max set to zero (tests/_torch_helpers.sweep_like_matrices
    with -110 and 0.75); uniform maps of the same shape."""
    rng = np.random.default_rng(B)
    A = rng.dirichlet(np.ones(3), size=3).astype(np.float32)
    E = rng.uniform(lowest, 0.0, size=(3, 1, B)).astype(np.float32)
    e = np.exp(E - E.max(axis=0, keepdims=True))
    e[(rng.random(e.shape) < zeros) & (e < 1.0)] = 0.0
    M = torch.from_numpy(A[:, :, None, None] * e[None]).cuda()
    return M, cs.fb_inputs(B, 3, 1, cs.SEED)[1]


def libraries(module, name: str, sources: list[str]) -> dict:
    """``module``'s kernel library built from each of ``sources`` (the
    parent's first, as "old") beside its current one: name -> library, in
    the order old, current, others."""
    libs = {"old": module._bind(ctypes.CDLL(str(_build.build(f"{name}_old",
                                                              [Path(sources[0])]).path)))}
    libs["current"] = module._library()
    for i, src in enumerate(sources[1:]):
        libs[Path(src).stem] = module._bind(ctypes.CDLL(str(
            _build.build(f"{name}_other{i}", [Path(src)]).path)))
    return libs


def parent_turns(sources: list[str]) -> None:
    """Each of ``sources`` (the parent's fbscan.cu first) against the
    current fbscan.cu, in turns, at every [fbscan] timed input."""
    # imported here: a tree from before the kernels has no fb_cuda, and t250 runs there too
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    libs = libraries(fb_cuda, "fbscan", sources)
    current = libs["current"]
    order = list(libs) + list(libs)[::-1]
    own = sweep_inputs()[0]
    B1 = own[1][0].shape[-1]
    inputs = {
        "P=1 sweep data": own[1],
        f"P={cs.P_SHARDED} sweep data": own[cs.P_SHARDED],
        "P=1 uniform": cs.fb_inputs(B1, 3, 1, cs.SEED),
        f"P={cs.P_SHARDED} uniform": cs.fb_inputs(own[cs.P_SHARDED][0].shape[-1], 3,
                                                  cs.P_SHARDED, cs.SEED),
        "T=250M per shard uniform": cs.fb_inputs(cs.FB_BIG, 3, 1, cs.SEED),
        "flat uniform": cs.fb_inputs(cs.FB_FLAT, 3, 1, cs.SEED),
        "K=10 uniform": cs.fb_inputs(B1, 10, 1, cs.SEED),
        # which entries of the sweep's matrices slow a division: zeros, subnormals, both
        "P=1 sweep-like, zeros, no subnormals": sweep_like(B1, -80.0, 0.75),
        "P=1 sweep-like, subnormals, no zeros": sweep_like(B1, -103.0, 0.0),
        "P=1 sweep-like": sweep_like(B1, -110.0, 0.75),
    }
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    try:
        for tag, (M, maps) in inputs.items():
            want = fb.prefix_matmul_scan_reference(M.contiguous())
            swant = fb.suffix_compose_scan_reference(maps.contiguous())
            row: dict = {"shape": tuple(M.shape), "order": order}
            for name in order:
                fb_cuda._lib = libs[name]
                prefix = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
                suffix = lambda: fb_cuda.suffix_compose_scan_cuda(maps)  # noqa: E731
                if name not in row:  # its first turn: bits and kernels per call
                    row[name] = {
                        "bitwise": cs.bits_equal(prefix(), want) and torch.equal(suffix(), swant),
                        "prefix_kernels": cs.scan_kernels(prefix),
                        "suffix_kernels": cs.scan_kernels(suffix),
                        "prefix_ms": [], "suffix_ms": []}
                entry = row[name]
                entry["prefix_ms"].append(cs.time_ms(prefix, cs.flushed(flush)))
                entry["suffix_ms"].append(cs.time_ms(suffix, cs.flushed(flush)))
            print("TURNS", tag, json.dumps(row), flush=True)
    finally:
        fb_cuda._lib = current


def model_turns(sources: list[str]) -> None:
    """Each of ``sources`` (the parent's modelupdate.cu first) against the
    current modelupdate.cu, in turns, at every [model] timed input."""
    from hammlet_tpu_torch.models import model_cuda

    libs = libraries(model_cuda, "modelupdate", sources)
    current = libs["current"]
    order = list(libs) + list(libs)[::-1]
    own = sweep_inputs()[1]
    B1 = own[1][0][0].shape[-1]
    inputs = {
        "P=1 sweep data": own[1],
        f"P={cs.P_SHARDED} sweep data": own[cs.P_SHARDED],
        "T=4M burn-in uniform": (cs.model_stats_inputs(1, cs.T_MAIN, 3, 1, cs.SEED), own[1][1]),
        "T=250M per shard uniform": (cs.model_stats_inputs(4, cs.FB_BIG, 3, 1, cs.SEED),
                                     own[cs.P_SHARDED][1]),
        "K=10 dim=3 uniform": (cs.model_stats_inputs(1, B1, 10, 3, cs.SEED),
                               cs.model_resample_inputs(10, cs.SEED)),
    }
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    try:
        for tag, (stats_args, resample_args) in inputs.items():
            parts = cs.resample_parts(resample_args)
            row: dict = {"shape": tuple(stats_args[0].shape) + tuple(stats_args[4].shape),
                         "order": order}
            for name in order:
                model_cuda._lib = libs[name]
                stats = lambda: model_cuda.sweep_stats_cuda(*stats_args)  # noqa: E731
                resample = lambda: model_cuda.resample_model_cuda(*parts)  # noqa: E731
                if name not in row:  # its first turn: bits and kernels per call
                    try:
                        cs.check_model(stats_args, resample_args, tag)
                        bitwise = True
                    except cs.SmokeFailure:
                        bitwise = False
                    row[name] = {"bitwise": bitwise, "stats_kernels": cs.scan_kernels(stats),
                                 "resample_kernels": cs.scan_kernels(resample),
                                 "stats_ms": [], "resample_ms": []}
                entry = row[name]
                entry["stats_ms"].append(cs.time_ms(stats, cs.flushed(flush)))
                entry["resample_ms"].append(cs.time_ms(resample, cs.flushed(flush)))
            print("MODEL_TURNS", tag, json.dumps(row), flush=True)
    finally:
        model_cuda._lib = current


#: [teams]: states of the uniform inputs at B = 29,696
TEAM_KS = [9, 10, 12, 16]
#: [wide]: states of the uniform inputs at B = 29,696 (33: the generic kernels in both)
WIDE_KS = [17, 20, 21, 27, 32, 33]
#: [wide]: (B, R) of the bitwise checks at every K of the wide instances
WIDE_BITS = [(130, 1), (1_024, 1), (1_024, 4), (29_696, 1), (9_600, 4)]


#: [deep]: states of the uniform inputs at B = 29,696 (-s C 6 2 is 36, -s C 4 3 is 64)
DEEP_KS = [33, 36, 48, 64]
#: [deep]: states of the bitwise checks with zeros, subnormals, -0, infinities and NaN
DEEP_SPECIAL_KS = [33, 48, 64]
#: [over64]: (B, K, R) of the inputs timed in turns against the generic kernels
OVER64_INPUTS = {"K=81 B=29696": (29_696, 81, 1), "K=128 B=29696": (29_696, 128, 1),
                 "K=160 B=2944": (2_944, 160, 1), "K=243 B=2944": (2_944, 243, 1)}
#: [over64]: states of the bitwise checks (-s C 3 4, C 5 3, C 2 7, C 3 5 and the edges of T)
OVER64_BITS_KS = [65, 72, 80, 81, 96, 97, 112, 113, 125, 128, 129, 160, 161, 192, 243, 256]
#: [over64]: states of the bitwise checks with zeros, subnormals, -0, infinities and NaN
OVER64_SPECIAL_KS = [65, 81, 128, 129, 243]
#: [over64]: the copies of fbscan.cu timed in turns: slabs of 32 or 16 values of j; the
#: registers of two CTAs per SM (128 a thread), of three at T <= 6 (85) or of one (255); the
#: j loop unrolled twice or once
OVER64_VARIANTS = {
    "slab32": [],
    "slab16": [["#define TILED_SLAB 32 ", "#define TILED_SLAB 16 "]],
    "blocks3": [["MIN_BLOCKS = 2;", "MIN_BLOCKS = T <= 6 ? 3 : 2;"]],
    "blocks1": [["MIN_BLOCKS = 2;", "MIN_BLOCKS = 1;"]],
    "unroll1": [["#pragma unroll 2\n  for (int jj = jb;", "#pragma unroll 1\n  for (int jj = jb;"]],
}
OVER64_VARIANT_KS = [81, 96, 128]
#: [deep]: the copies of fbscan.cu timed in turns: the tile shapes
DEEP_VARIANTS = {
    "mats2": [],
    "mats1": [["#define DEEP_MATS 2", "#define DEEP_MATS 1"]],
    "side16": [["#define DEEP_SIDE 8 ", "#define DEEP_SIDE 16 "]],
}


def deep_inputs() -> dict:
    """`deep`'s inputs: tag -> (B, K, R)."""
    inputs = {f"K={K} B=29696": (29_696, K, 1) for K in DEEP_KS}
    inputs.update({"K=64 B=9600 R=4": (9_600, 64, 4), "K=64 B=29696 sweep-like": (29_696, 64, 1)})
    return inputs


def team_inputs() -> dict:
    """`teams`' inputs: tag -> (B, K, R)."""
    inputs = {f"K={K} B=29696": (29_696, K, 1) for K in TEAM_KS}
    inputs.update({"K=9 B=9600 R=4": (9_600, 9, 4), "K=16 B=16384": (16_384, 16, 1),
                   "K=9 B=433920": (cs.FB_BIG, 9, 1), "K=16 B=433920": (cs.FB_BIG, 16, 1),
                   "K=9 flat B=100000": (100_000, 9, 1), "K=16 flat B=100000": (100_000, 16, 1),
                   "K=9 B=29696 sweep-like": (29_696, 9, 1), "K=27 B=29696": (29_696, 27, 1)})
    return inputs


def wide_inputs() -> dict:
    """`wide`'s inputs: tag -> (B, K, R)."""
    inputs = {f"K={K} B=29696": (29_696, K, 1) for K in WIDE_KS}
    inputs.update({"K=27 B=9600 R=4": (9_600, 27, 4), "K=17 B=433920": (cs.FB_BIG, 17, 1),
                   "K=27 B=433920": (cs.FB_BIG, 27, 1), "K=32 B=433920": (cs.FB_BIG, 32, 1),
                   "K=27 flat B=100000": (100_000, 27, 1),
                   "K=27 B=29696 sweep-like": (29_696, 27, 1)})
    return inputs


def print_ptxas(log: str, kinds: tuple, tag: str = "") -> None:
    """ptxas's registers and spills of every kernel of a build log whose
    name holds one of ``kinds`` (lines "PTXAS [tag] ...")."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(kind in line for kind in kinds):
            print("PTXAS", *([tag] if tag else []), line.strip(), "|",
                  " | ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "ptxas info" in x or "spill" in x), flush=True)


def wide_bits(ks, special_ks: tuple, largest_k: int = 1 << 30) -> None:
    """Each K of ``ks`` against the plain versions at WIDE_BITS (above 4,096
    blocks only up to ``largest_k``), at ``special_ks`` with zeros and subnormals,
    with -0 and an infinity, and with a NaN: prints "WIDE_BITS <json>" with
    the cases that were not bitwise (prefix) or equal (suffix)."""
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    bad, cases = [], 0
    for K in ks:
        for B, R in WIDE_BITS:
            if B * R > 4_096 and K > largest_k:
                continue
            M, maps = cs.fb_inputs(B, K, R, B + K + R)
            variants = {"uniform": M}
            if K in special_ks and R == 1:
                u = torch.rand(M.shape, generator=torch.Generator(device="cuda").manual_seed(B),
                               device="cuda")
                variants["zeros and subnormals"] = torch.where(
                    u < 0.4, 0.0, torch.where(u < 0.45, M * 1e-39, M))
                variants["-0 and inf"] = M.clone()
                variants["-0 and inf"][:, :, 0, 5:9] = -0.0
                variants["-0 and inf"][0, 0, 0, B // 2] = float("inf")
                variants["NaN"] = M.clone()
                variants["NaN"][1, 2, 0, B // 3] = float("nan")
            for name, X in variants.items():
                cases += 1
                if not cs.bits_equal(fb_cuda.prefix_matmul_scan_cuda(X),
                                     fb.prefix_matmul_scan_reference(X)):
                    bad.append(("prefix", K, B, R, name))
            cases += 1
            if not torch.equal(fb_cuda.suffix_compose_scan_cuda(maps),
                               fb.suffix_compose_scan_reference(maps)):
                bad.append(("suffix", K, B, R))
    torch.cuda.synchronize()
    print("WIDE_BITS", json.dumps({"cases": cases, "not_bitwise": bad}), flush=True)


def team_turns(old: str, inputs: dict, kinds: tuple) -> None:
    """`teams`, `wide`, `deep` and `over64`: the current fbscan.cu against
    the parent's, in turns, at ``inputs`` (see the module's docstring);
    first the ptxas lines of the kernels whose names hold one of
    ``kinds``."""
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    print_ptxas(fb_cuda.build().log, kinds)
    libs = libraries(fb_cuda, "fbscan", [old])
    current = libs["current"]
    order = ["old", "current", "current", "old"]
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    try:
        for tag, (B, K, R) in inputs.items():
            M, maps = cs.fb_inputs(B, K, R, cs.SEED + K)
            if "sweep-like" in tag:
                u = torch.rand(M.shape, generator=torch.Generator(device="cuda").manual_seed(B),
                               device="cuda")
                M = torch.where(u < 0.4, 0.0, torch.where(u < 0.45, M * 1e-39, M))
            want = fb.prefix_matmul_scan_reference(M)
            swant = fb.suffix_compose_scan_reference(maps)
            row: dict = {"shape": (B, K, R), "order": order}
            for name, (nbytes, ops) in cs.fb_work(B, K, R).items():
                row[name + "_bound"] = cs.bound_ms(nbytes, ops)
            for name in order:
                fb_cuda._lib = libs[name]
                prefix = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
                suffix = lambda: fb_cuda.suffix_compose_scan_cuda(maps)  # noqa: E731
                if name not in row:
                    row[name] = {
                        "prefix_bitwise": cs.bits_equal(prefix(), want),
                        "suffix_equal": torch.equal(suffix(), swant),
                        "prefix_kernels": cs.scan_kernels(prefix),
                        "suffix_kernels": cs.scan_kernels(suffix),
                        "prefix_ms": [], "suffix_ms": []}
                slow = name == "old" and (K > 8 and B > 29_696 or K > 16)
                reps = (2 if K > 64 else 5) if slow else cs.TIMING_REPS
                row[name]["prefix_ms"].append(cs.time_ms(prefix, cs.flushed(flush), reps))
                row[name]["suffix_ms"].append(cs.time_ms(suffix, cs.flushed(flush), reps))
            print("TEAMS", tag, json.dumps(row), flush=True)
            del M, maps, want, swant
            torch.cuda.empty_cache()
    finally:
        fb_cuda._lib = current


#: (text of csrc/modelupdate.cu, the same with a stamp) for `stamps`, in order
STAMP_AT = [
    ("  extern __shared__ float smem[];\n  const bool staged",
     "  extern __shared__ float smem[];\n  STAMP(0);\n  const bool staged"),
    ("      cp_async_wait_all();\n      __syncthreads();  // tile c is staged; the other stage is free\n",
     "      STAMP(1);\n      cp_async_wait_all();\n"
     "      __syncthreads();  // tile c is staged; the other stage is free\n      STAMP(2);\n"),
    ("      float* tree_a = base;", "      STAMP(3);\n      float* tree_a = base;"),
    ("        __syncthreads();\n        // the cross-thread levels",
     "        __syncthreads();\n        STAMP(4);\n        // the cross-thread levels"),
    ("        // the tile's sums (an odd", "        STAMP(5);\n        // the tile's sums (an odd"),
    ("  cp_async_wait_all();  // a CTA without items",
     "  STAMP(6);\n  cp_async_wait_all();  // a CTA without items"),
    ("  cg::this_grid().sync();\n", "  cg::this_grid().sync();\n  STAMP(7);\n"),
    ("    __syncthreads();\n    if (tid == 0) {\n      float value",
     "    __syncthreads();\n    STAMP(8);\n    if (tid == 0) {\n      float value"),
    ("      out[(long long)r * n_out + o] = value;\n    }\n  }\n}",
     "      out[(long long)r * n_out + o] = value;\n    }\n  }\n  STAMP(9);\n}"),
]

STAMP_CODE = r"""
__device__ unsigned long long stamps_t[4096 * 10];
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x < 4096) stamps_t[blockIdx.x * 10 + (k)] = stamp_now(); } while (0)
extern "C" int stamps_clear() {
  static unsigned long long zero[4096 * 10];
  return (int)cudaMemcpyToSymbol(stamps_t, zero, sizeof(zero));
}
extern "C" int stamps_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, stamps_t, sizeof(unsigned long long) * 4096 * 10);
}
__global__ void empty_kernel(int* p) { if (p) p[threadIdx.x] = 1; }
__global__ void empty_barrier_kernel(int* p) {
  cg::this_grid().sync();
  if (p) p[threadIdx.x] = 1;
}
extern "C" int launch_empty(int cooperative, int grid, void* stream) {
  int* p = nullptr;
  void* argv[] = {&p};
  if (cooperative)
    return (int)cudaLaunchCooperativeKernel((const void*)empty_barrier_kernel, dim3(grid), dim3(128),
                                            argv, 0, (cudaStream_t)stream);
  empty_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
"""


#: (text of fbscan.cu's one-launch team kernel, the same with a stamp) for `team_stamps`
TEAM_STAMP_AT = [
    ("  const TeamSmem<K> sm(smem_team, team_room(G));",
     "  STAMP(0);\n  const TeamSmem<K> sm(smem_team, team_room(G));"),
    ("  team_load<K>(in, sm.s, plane, base);\n  __syncthreads();\n  Cols<K> x[Team<K>::ITEMS];\n"
     "  team_group_levels<K>(sm, x);\n",
     "  team_load<K>(in, sm.s, plane, base);\n  __syncthreads();\n  STAMP(1);\n"
     "  Cols<K> x[Team<K>::ITEMS];\n  team_group_levels<K>(sm, x);\n  STAMP(2);\n"),
    ("  team_total<K>(x, row, q);\n", "  team_total<K>(x, row, q);\n  STAMP(3);\n"),
    ("  cg::this_grid().sync();\n  const float* pre = sm.eye;",
     "  cg::this_grid().sync();\n  STAMP(4);\n  const float* pre = sm.eye;"),
    ("  team_combine<K>([=](int) { return pre; }, sm.s, sm.red, x);\n  team_store<K>(sm.s, out, plane, base);\n}",
     "  STAMP(5);\n  team_combine<K>([=](int) { return pre; }, sm.s, sm.red, x);\n  STAMP(6);\n"
     "  team_store<K>(sm.s, out, plane, base);\n  __syncthreads();\n  STAMP(7);\n}"),
]


def stamped_call(lib, call, before, stamps: int) -> dict:
    """One call of ``call`` after ``before`` with the stamps of a library
    built with STAMP_CODE cleared first: the CTAs that stamped, and per
    stamp k < ``stamps`` the microseconds after the first CTA's entry,
    [min, median, max] over the CTAs."""
    lib.stamps_clear()
    before()
    call()
    torch.cuda.synchronize()
    raw = np.zeros(4096 * 10, np.uint64)
    lib.stamps_read(raw.ctypes.data)
    t = raw.reshape(4096, 10).astype(np.int64)
    t = t[t[:, 0] > 0]
    row = {"ctas": len(t)}
    for k in range(stamps):
        col = t[:, k][t[:, k] > 0]
        us = (col - t[:, 0].min()) / 1e3
        row[f"s{k}"] = ([round(float(f(us)), 2) for f in (np.min, np.median, np.max)]
                        if col.size else None)
    return row


def variant_turns(ks: list[int], substitutions: dict,
                  kinds: tuple = ("wide", "team_rows", "team_combine", "suffix_one",
                                  "deep"), sizes: tuple = (29_696, cs.FB_BIG)) -> None:
    """`variants`: copies of fbscan.cu with text substituted, timed in
    turns (see the module's docstring), at B in ``sizes``."""
    from concurrent.futures import ThreadPoolExecutor

    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    src = fb_cuda.SOURCES[0].read_text()
    for call in ("prefix_at<1>(K,", "suffix_at<1>(K,"):  # K >= min(ks) only, to build in seconds
        if call not in src:
            raise SystemExit(f"variants: csrc/fbscan.cu no longer has {call!r}")
        src = src.replace(call, call.replace("<1>", f"<{min(ks)}>"), 1)

    def build(item):
        name, subs = item
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variants: {name}: csrc/fbscan.cu has no {old!r}")
            text = text.replace(old, new)
        path = _build.BUILD_DIR / "probe" / f"fbscan_variant_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        return name, _build.build(f"fbscan_variant_{name}", [path])

    with ThreadPoolExecutor(len(substitutions)) as pool:
        built = list(pool.map(build, substitutions.items()))
    libs = {}
    for name, b in built:
        print_ptxas(b.log, kinds, name)
        print("BUILT", name, round(b.seconds, 1), flush=True)
        libs[name] = fb_cuda._bind(ctypes.CDLL(str(b.path)))
    current = fb_cuda._library()
    order = list(libs) + list(libs)[::-1]
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    try:
        for K in ks:
            for B in sizes:
                M, maps = cs.fb_inputs(B, K, 1, cs.SEED + K)
                want = fb.prefix_matmul_scan_reference(M)
                swant = fb.suffix_compose_scan_reference(maps)
                row: dict = {"shape": (B, K, 1), "order": order}
                for name in order:
                    fb_cuda._lib = libs[name]
                    prefix = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
                    suffix = lambda: fb_cuda.suffix_compose_scan_cuda(maps)  # noqa: E731
                    if name not in row:
                        row[name] = {
                            "bitwise": cs.bits_equal(prefix(), want) and torch.equal(suffix(), swant),
                            "prefix_kernels": [(cs.kernel_label(n), c)
                                               for n, c in cs.scan_kernels(prefix)],
                            "prefix_ms": [], "suffix_ms": []}
                    row[name]["prefix_ms"].append(cs.time_ms(prefix, cs.flushed(flush), 10))
                    row[name]["suffix_ms"].append(cs.time_ms(suffix, cs.flushed(flush), 10))
                print("VARIANTS", json.dumps(row), flush=True)
                del M, maps, want, swant
                torch.cuda.empty_cache()
    finally:
        fb_cuda._lib = current


def over64_alone() -> None:
    """`over64`'s last part: the current scans alone at K = 96, 160 and 243,
    B = 29,696 (the generic kernels would take seconds a call there)."""
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for K in (96, 160, 243):
        M, maps = cs.fb_inputs(29_696, K, 1, cs.SEED + K)
        prefix = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
        suffix = lambda: fb_cuda.suffix_compose_scan_cuda(maps)  # noqa: E731
        row: dict = {"shape": (29_696, K, 1),
                     "prefix_kernels": [(cs.kernel_label(n), c) for n, c in cs.scan_kernels(prefix)],
                     "suffix_kernels": [(cs.kernel_label(n), c) for n, c in cs.scan_kernels(suffix)],
                     "prefix_ms": cs.time_ms(prefix, cs.flushed(flush), 10),
                     "suffix_ms": cs.time_ms(suffix, cs.flushed(flush), 10)}
        for name, (nbytes, ops) in cs.fb_work(29_696, K, 1).items():
            row[name + "_bound"] = cs.bound_ms(nbytes, ops)
        if K < 243:  # the plain versions: one call each (at 243 their tensors would not fit beside)
            row["prefix_plain_ms"] = cs.time_ms(lambda: fb.prefix_matmul_scan_reference(M),
                                                cs.flushed(flush), 1)
            row["suffix_plain_ms"] = cs.time_ms(lambda: fb.suffix_compose_scan_reference(maps),
                                                cs.flushed(flush), 1)
        print("ALONE", json.dumps(row), flush=True)
        del M, maps, prefix, suffix
        torch.cuda.empty_cache()


def ptxas_lines(log: str, symbol: str) -> str:
    """ptxas's registers and spills of the kernel whose mangled name holds
    ``symbol``, from a build log (-Xptxas=-v)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and symbol in line:
            return " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                              if "spill" in x or "Used" in x)
    return ""


def team_stamps(sources: list[str]) -> None:
    """`team_stamps`: the one-launch team kernel with globaltimer stamps
    (see the module's docstring)."""
    import re

    from hammlet_tpu_torch.samplers import fb_cuda

    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    current = fb_cuda._library()
    for i, source in enumerate(sources or [str(fb_cuda.SOURCES[0])]):
        src = Path(source).read_text()
        for at, stamped in TEAM_STAMP_AT:
            if at not in src:
                raise SystemExit(f"team_stamps: {source} no longer has {at!r}")
            src = src.replace(at, stamped, 1)
        src = src.replace("namespace cg = cooperative_groups;\n",
                          "namespace cg = cooperative_groups;\n" + STAMP_CODE, 1)
        # K <= 10 only (and the generic instances), to build in seconds
        src = re.sub(r"#define MAX_WIDE_K \d+", "#define MAX_WIDE_K 10", src)
        path = _build.BUILD_DIR / "probe" / f"fbscan_stamps{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        built = _build.build(f"fbscan_stamps{i}", [path])
        lib = fb_cuda._bind(ctypes.CDLL(str(built.path)))
        lib.stamps_read.argtypes = [ctypes.c_void_p]
        fb_cuda._lib = lib
        try:
            for K in (9, 10):
                M = cs.fb_inputs(29_696, K, 1, cs.SEED)[0]
                call = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
                ms = cs.time_ms(call, cs.flushed(flush))
                row = {"source": source, "K": K, "ms": ms, "build_s": round(built.seconds, 1),
                       "ptxas": ptxas_lines(built.log, f"team_one_kernelILi{K}E"),
                       **stamped_call(lib, call, cs.flushed(flush), 8)}
                print("TEAM_STAMPS", json.dumps(row), flush=True)
        finally:
            fb_cuda._lib = current


def stamps() -> None:
    """`stamps`: the statistics kernel with globaltimer stamps, and the
    timing floor (see the module's docstring)."""
    from hammlet_tpu_torch.models import model_cuda

    src = model_cuda.SOURCES[0].read_text()
    for at, stamped in STAMP_AT:
        if at not in src:
            raise SystemExit(f"stamps: csrc/modelupdate.cu no longer has {at!r}")
        src = src.replace(at, stamped, 1)
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + STAMP_CODE, 1)
    path = _build.BUILD_DIR / "probe" / "modelupdate_stamps.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = model_cuda._bind(ctypes.CDLL(str(_build.build("modelupdate_stamps", [path]).path)))
    lib.stamps_read.argtypes = [ctypes.c_void_p]
    lib.launch_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    modes = {"warm": lambda: torch.cuda._sleep(cs.SLEEP_CYCLES), "flushed": cs.flushed(flush)}
    print(cs.nvidia_smi_line(), flush=True)
    for cooperative, grid in ((0, 29), (1, 145)):
        empty = lambda: lib.launch_empty(cooperative, grid, torch.cuda.current_stream().cuda_stream)  # noqa: E731
        print("EMPTY", json.dumps({"cooperative": cooperative, "grid": grid, **{
            mode: cs.time_ms(empty, before) for mode, before in modes.items()}}), flush=True)
    current = model_cuda._library()
    model_cuda._lib = lib
    try:
        for tag, (R, B) in {"P=1 capacity": (1, 29_696), "T=250M per shard": (4, cs.FB_BIG)}.items():
            args = cs.model_stats_inputs(R, B, 3, 1, cs.SEED)
            call = lambda: model_cuda.sweep_stats_cuda(*args)  # noqa: E731
            for mode, before in modes.items():
                ms = cs.time_ms(call, before)
                row = {"input": tag, "mode": mode, "ms": ms,
                       **stamped_call(lib, call, before, 10)}
                print("STAMPS", json.dumps(row), flush=True)
    finally:
        model_cuda._lib = current


#: `over512`: the tiled kernel against the parent's in turns, tag -> (B, K, R) and repetitions
OVER512_TURNS = {"K=81": ((29_696, 81, 1), 20), "K=128": ((29_696, 128, 1), 10),
                 "K=243": ((29_696, 243, 1), 5)}
#: `over512`: the current kernel alone above K = 512, (B, K)
OVER512_ALONE = [(B, K) for K in (513, 625, 729, 1024) for B in (384, 4096)]


def over512(old: str) -> None:
    """`over512` (see the module's docstring)."""
    from hammlet_tpu_torch.samplers import fb_cuda

    print_ptxas(fb_cuda.build().log, ("tiled",))
    libs = libraries(fb_cuda, "fbscan", [old])
    current = libs["current"]
    order = ["old", "current", "current", "old"]
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    try:
        for tag, ((B, K, R), reps) in OVER512_TURNS.items():
            M, _ = cs.fb_inputs(B, K, R, cs.SEED + K)
            prefix = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
            row: dict = {"shape": (B, K, R), "order": order,
                         "bound": cs.bound_ms(*cs.fb_work(B, K, R)["prefix"])}
            fb_cuda._lib = libs["old"]
            want = prefix()
            for name in order:
                fb_cuda._lib = libs[name]
                if name not in row:
                    row[name] = {"bitwise_to_old": cs.bits_equal(prefix(), want),
                                 "kernels": cs.scan_kernels(prefix), "ms": []}
                row[name]["ms"].append(cs.time_ms(prefix, cs.flushed(flush), reps))
            print("OVER512_TURNS", tag, json.dumps(row), flush=True)
            del M, want
            torch.cuda.empty_cache()
    finally:
        fb_cuda._lib = current
    for B, K in OVER512_ALONE:
        M, _ = cs.fb_inputs(B, K, 1, cs.SEED + K)
        prefix = lambda: fb_cuda.prefix_matmul_scan_cuda(M)  # noqa: E731
        row = {"shape": (B, K, 1), "kernels": cs.scan_kernels(prefix),
               "ms": cs.time_ms(prefix, cs.flushed(flush), 3),
               "bound": cs.bound_ms(*cs.fb_work(B, K, 1)["prefix"])}
        print("OVER512_ALONE", json.dumps(row), flush=True)
        del M
        torch.cuda.empty_cache()


def prior_peak(K: int, T: int = 400_000) -> None:
    """The prior_peak probe (module docstring)."""
    from hammlet_tpu_torch import runner

    steps, n_params = {9: (cs.config4_steps, 3), 27: (cs.states27_steps, 3),
                       64: (cs.states64_steps, 4), 81: (cs.states81_steps, 3),
                       625: (cs.states625_steps, 5)}[K]
    data = steps(T)[0]
    eng = runner.make_engine(data, nr_params=n_params, nr_data_dim=data.shape[1], seed=1)
    eng.sample_prior()
    eng._resize_capacity_for_phase()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    row = {"K": K, "T": T, "capacity": eng.capacity, "base_mib": base / 2**20, "error": None}
    t0 = time.perf_counter()
    try:
        eng.run("F", 16, 0)
        torch.cuda.synchronize()
    except torch.OutOfMemoryError as exc:
        row["error"] = str(exc)
    row.update(seconds=round(time.perf_counter() - t0, 3),
               capture_seconds=round(eng.phase_graphs.capture_seconds, 3),
               peak_allocated_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
               peak_reserved_mib=torch.cuda.max_memory_reserved() / 2**20)
    print("PRIOR_PEAK", json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("fbscan_probes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["t250"]:
        n, T, settled, turns = map(int, sys.argv[2:6])
        rc, res = launch.run_on_cards("fbscan_probes:big", n, (n, T, settled, turns))
        print("T250", rc, json.dumps(res), flush=True)
        return rc
    if sys.argv[1:2] == ["teams"] and len(sys.argv) == 3:
        team_turns(sys.argv[2], team_inputs(), ("team", "suffix_one"))
        return 0
    if sys.argv[1:2] == ["wide"] and len(sys.argv) == 3:
        # team_turns first: its build prints the ptxas lines (a built library has no log)
        team_turns(sys.argv[2], wide_inputs(), ("wide", "team_rows", "team_combine", "suffix_one"))
        wide_bits(range(17, 34), (27,))
        return 0
    if sys.argv[1:2] == ["deep"] and len(sys.argv) == 3:
        kinds = ("deep", "suffix_one", "suffix_group", "suffix_rows")
        team_turns(sys.argv[2], deep_inputs(), kinds)
        wide_bits(range(33, 66), tuple(DEEP_SPECIAL_KS))
        variant_turns(DEEP_KS, DEEP_VARIANTS, kinds)
        return 0
    if sys.argv[1:2] == ["over64"] and len(sys.argv) == 3:
        kinds = ("tiled", "suffix_group", "suffix_rows", "suffix_combine")
        team_turns(sys.argv[2], OVER64_INPUTS, kinds)
        wide_bits(OVER64_BITS_KS, tuple(OVER64_SPECIAL_KS), largest_k=128)
        variant_turns(OVER64_VARIANT_KS, OVER64_VARIANTS, kinds, sizes=(29_696,))
        over64_alone()
        return 0
    if sys.argv[1:2] == ["variants"] and len(sys.argv) == 4:
        variant_turns([int(k) for k in sys.argv[2].split(",")], json.loads(sys.argv[3]))
        return 0
    if sys.argv[1:2] == ["team_stamps"]:
        team_stamps(sys.argv[2:])
        return 0
    if sys.argv[1:] == ["stamps"]:
        stamps()
        return 0
    if sys.argv[1:2] == ["prior_peak"] and len(sys.argv) in (3, 4):
        prior_peak(*map(int, sys.argv[2:]))
        return 0
    if sys.argv[1:2] == ["over512"] and len(sys.argv) == 3:
        over512(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["turns"] and len(sys.argv) > 2:
        model = [src for src in sys.argv[2:] if "hammlet_sweep_stats" in Path(src).read_text()]
        scans = [src for src in sys.argv[2:] if src not in model]
        if scans:
            parent_turns(scans)
        if model:
            model_turns(model)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
