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

    python3 fbscan_probes.py one-cta OLD_FBSCAN_CU
        An older fbscan.cu built beside the current one; both scans of each
        at a flat B = 500,000 and at B = 433,920 (K = 3, one row), checked
        bitwise against the plain versions and timed with L2 flushed (old,
        current, old).

Needs one card (one-cta) or N (t250); imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
import time
from pathlib import Path

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


def one_cta(old_source: str) -> None:
    # imported here: a tree from before the kernels has no fb_cuda, and t250 runs there too
    from hammlet_tpu_torch.samplers import fb_cuda
    from hammlet_tpu_torch.samplers import forward_backward as fb

    old = fb_cuda._bind(ctypes.CDLL(str(_build.build("fbscan_old", [Path(old_source)]).path)))
    new = fb_cuda._library()
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    print(cs.nvidia_smi_line(), flush=True)
    try:
        for B in (cs.FB_FLAT, cs.FB_BIG):
            M, maps = cs.fb_inputs(B, 3, 1, cs.SEED)
            want, swant = fb.prefix_matmul_scan_reference(M), fb.suffix_compose_scan_reference(maps)
            row = {}
            for tag, lib in (("old", old), ("current", new), ("old again", old)):
                fb_cuda._lib = lib
                ok = (cs.bits_equal(fb_cuda.prefix_matmul_scan_cuda(M), want)
                      and torch.equal(fb_cuda.suffix_compose_scan_cuda(maps), swant))
                row[tag] = (ok, cs.time_ms(lambda: fb_cuda.prefix_matmul_scan_cuda(M), flush.zero_),
                            cs.time_ms(lambda: fb_cuda.suffix_compose_scan_cuda(maps), flush.zero_))
            print(f"[one-cta] B={B} K=3 R=1 (bitwise, prefix ms, suffix ms, L2 flushed): {row}",
                  flush=True)
    finally:
        fb_cuda._lib = new


def main() -> int:
    if not torch.cuda.is_available():
        print("fbscan_probes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["t250"]:
        n, T, settled, turns = map(int, sys.argv[2:6])
        rc, res = launch.run_on_cards("fbscan_probes:big", n, (n, T, settled, turns))
        print("T250", rc, json.dumps(res), flush=True)
        return rc
    if sys.argv[1:2] == ["one-cta"]:
        one_cta(sys.argv[2])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
