#!/usr/bin/env python3
"""Card probes of the FB scan kernels (csrc/fbscan.cu) beyond chip_smoke.py.

    python3 fbscan_probes.py t250 N T SETTLED TURNS
        chip_smoke.py's [cards] (d) (T positions of BigData, BIG_SCHEME, -D N
        over N cards, one process per card), then TURNS settled
        ``F SETTLED 4`` phases on the same engine and torch.profiler over
        F 16 4 on rank 0. Prints one line "T250 <json>": setup seconds, the
        scheme's phases and their captures, the settled sweeps/s, kernels
        and device ms per sweep and the costliest kernels. To compare two
        trees, copy this file into the root of each (e.g. the parent
        unpacked with ``git archive``) and run it there in turns.

    python3 fbscan_probes.py turns OLD_FBSCAN_CU [OTHER_CU ...]
        The parent's fbscan.cu (e.g. ``git show HEAD~1:hammlet_tpu_torch/
        csrc/fbscan.cu`` written to a git-ignored file) built beside the
        current one, and any further sources beside them, at every timed
        input of chip_smoke.py's [fbscan]: the sweep's own matrices and maps
        at P = 1 and P = 4 (taken from eager engines at T = 4M), uniform
        inputs at those shapes, B = 433,920, a flat B = 500,000 and K = 10.
        On each input each library is checked against the plain versions
        (prefix bitwise, suffix equal), its CUDA kernels per call are
        counted, and both scans are timed with L2 flushed, the libraries in
        turns (old, current, others, others reversed, current, old). Prints
        one line "TURNS <json>" per input.

Needs one card (turns) or N (t250); imports no JAX.
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


def sweep_inputs() -> dict:
    """The sweep's own (M, maps) at P = 1 and P = P_SHARDED: the largest
    scan call of each kind of an eager engine's settled F sweeps at T_MAIN
    (chip_smoke.py's configuration)."""
    from hammlet_tpu_torch import runner

    data = cs.synth(cs.T_MAIN, cs.SEED)[0]
    got = {}
    for P in (1, cs.P_SHARDED):
        if P == 1:
            eng = runner.make_engine(data, nr_params=3, seed=cs.SEED, device="cuda")
            cs.eager_engine(eng)
        else:
            eng = sharded.make_sharded_engine(data, n_devices=P, nr_params=3, seed=cs.SEED,
                                              device="cuda")
            cs.eager_sharded_engine(eng)
        eng.run_scheme(["M", "64", "0", "F", "64", "4"])
        with cs.ScanInputs() as scans:
            eng.run("F", 4, 4)
        got[P] = scans.main_and_others()[0]
        del eng
    torch.cuda.empty_cache()
    return got


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


def parent_turns(sources: list[str]) -> None:
    """Each of ``sources`` (the parent's fbscan.cu first) against the
    current fbscan.cu, in turns, at every [fbscan] timed input."""
    # imported here: a tree from before the kernels has no fb_cuda, and t250 runs there too
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    current = fb_cuda._library()
    libs = {"old": fb_cuda._bind(ctypes.CDLL(str(
        _build.build("fbscan_old", [Path(sources[0])]).path)))}
    libs["current"] = current
    for i, src in enumerate(sources[1:]):
        libs[Path(src).stem] = fb_cuda._bind(ctypes.CDLL(str(
            _build.build(f"fbscan_other{i}", [Path(src)]).path)))
    order = list(libs) + list(libs)[::-1]
    own = sweep_inputs()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("fbscan_probes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["t250"]:
        n, T, settled, turns = map(int, sys.argv[2:6])
        rc, res = launch.run_on_cards("fbscan_probes:big", n, (n, T, settled, turns))
        print("T250", rc, json.dumps(res), flush=True)
        return rc
    if sys.argv[1:2] == ["turns"] and len(sys.argv) > 2:
        parent_turns(sys.argv[2:])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
