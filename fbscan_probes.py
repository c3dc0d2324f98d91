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
                lib.stamps_clear()
                before()
                call()
                torch.cuda.synchronize()
                raw = np.zeros(4096 * 10, np.uint64)
                lib.stamps_read(raw.ctypes.data)
                t = raw.reshape(4096, 10).astype(np.int64)
                t = t[t[:, 0] > 0]
                row = {"input": tag, "mode": mode, "ms": ms, "ctas": len(t)}
                for k in range(10):
                    col = t[:, k][t[:, k] > 0]
                    us = (col - t[:, 0].min()) / 1e3
                    row[f"s{k}"] = ([round(float(f(us)), 2) for f in (np.min, np.median, np.max)]
                                    if col.size else None)
                print("STAMPS", json.dumps(row), flush=True)
    finally:
        model_cuda._lib = current


def main() -> int:
    if not torch.cuda.is_available():
        print("fbscan_probes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["t250"]:
        n, T, settled, turns = map(int, sys.argv[2:6])
        rc, res = launch.run_on_cards("fbscan_probes:big", n, (n, T, settled, turns))
        print("T250", rc, json.dumps(res), flush=True)
        return rc
    if sys.argv[1:] == ["stamps"]:
        stamps()
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
