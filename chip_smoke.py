#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hammlet_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero and prints no result):
1. card: nvidia-smi name and power limit, torch's device name;
2. build: nvcc builds csrc/maxlet.cu for sm_90a into hammlet_tpu_torch/build/;
3. kernel: the Hopper maxlet kernel against its plain torch versions, on the
   card and on the CPU, bit for bit, at the sizes the main path uses; times;
4. main path: make_engine -> run_scheme("M 64 0 F 512 4") -> finalize at
   T = 4,000,000 positions, 3 states (the repo benchmark's configuration),
   checking that ingest went through the kernel, that every marginal row
   sums to the 128 recorded sweeps, and that the MAP state agrees with the
   true segmentation on >= 95% of positions;
5. settled: on phase 4's engine after its run, F 512 4 with marginals +
   parameters + compression and with every stream, in the order m a a m
   after a warm-up, giving settled sweeps/s and the host record drain's ms
   per 128-sweep chunk; then torch.profiler over F 64 4 with HAMMLET_DEBUG
   off and on, giving CUDA kernels and device ms per sweep (the invariant
   bitmask must add kernels when on);
6. cli: the same data as a text file through hammlet_tpu_torch.cli.main with
   all seven outputs (-i M 64 0 F 512 4), checking the engine ran on the
   card through the kernel and every stream's structure (one line per
   recorded sweep; blocks and sequences cover T; compression is T/#blocks;
   sequence boundaries lie on marginals boundaries; each segments line
   counts the union of the boundaries recorded so far; rows sum to 128;
   MAP agreement); prints the all-streams F-phase rate and its ratio to
   phase 4's;
7. resume: at T = 200,000, M 32 0 -> save_checkpoint -> new engine ->
   restore_checkpoint -> F 64 4 must equal the uninterrupted run bit for bit
   (marginal counts and emission means);
8. debug: with HAMMLET_DEBUG=1 a healthy F chunk reports error bits 0 and a
   NaN emission mean raises FloatingPointError;
then the kernels JSON line, the nvidia-smi line, and the result line.

Needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from itertools import permutations

import numpy as np
import torch

from hammlet_tpu_torch import checkpoint, cli, native, runner
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.ops import wavelet, wavelet_cuda

T_MAIN = 4_000_000
T_RESUME = 200_000
SCHEME = "M 64 0 F 512 4"
N_RECORDED = 128  # F 512 sweeps at thinning 4
SEGLEN = 500
SEED = 0
MAP_AGREEMENT_MIN = 0.95
KERNEL_SIZES = [100, 8192, 8193, 100_000, 4_000_000]
KERNEL_DIMS = [1, 3]
TIMING_REPS = 20


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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    """Bitwise equality of two float32 tensors (NaNs equal where both are
    NaN: their payloads are not part of the contract)."""
    a = a.cpu()
    b = b.cpu()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return False
    keep = ~nan_a
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def max_abs_err(a, b) -> float:
    a, b = a.cpu(), b.cpu()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median milliseconds per call from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def phase_kernel() -> dict:
    """Kernel vs plain torch, bitwise, on the card and on the CPU."""
    chunk = 1 << wavelet_cuda.CHUNK_BITS
    worst = 0.0
    for T in KERNEL_SIZES:
        for dim in KERNEL_DIMS:
            data = np.random.default_rng(T * 7 + dim).normal(1, 2, (T, dim))
            x_cpu = torch.from_numpy(data.astype(np.float32))
            x = x_cpu.cuda()
            got = wavelet_cuda.maxlet_transform_cuda(x)
            plain = wavelet.maxlet_transform(x)
            plain_cpu = wavelet.maxlet_transform(x_cpu)
            check(got.shape == (T,) and got.dtype == torch.float32, f"shape T={T}")
            check(bits_equal(got, plain), f"kernel != plain on card, T={T} dim={dim}")
            check(bits_equal(got, plain_cpu), f"kernel != plain on CPU, T={T} dim={dim}")
            # the kernel's own outputs against its plain version
            Tp = -(-T // chunk) * chunk
            data_t = torch.nn.functional.pad(x.T, (0, Tp - T)).contiguous()
            kc, kt = wavelet_cuda.maxlet_chunks_cuda(data_t)
            rc, rt = wavelet_cuda.maxlet_chunks_reference(data_t)
            check(bits_equal(kc, rc) and bits_equal(kt, rt), f"chunk outputs T={T} dim={dim}")
            worst = max(worst, max_abs_err(got, plain), max_abs_err(kc, rc))
    # NaN input: the max over dims must propagate NaN like the plain version
    data = np.random.default_rng(5).normal(0, 1, (100_000, 3)).astype(np.float32)
    data[[17, 4096, 8191, 77_777], [0, 2, 1, 2]] = np.nan
    x = torch.from_numpy(data).cuda()
    check(
        bits_equal(wavelet_cuda.maxlet_transform_cuda(x), wavelet.maxlet_transform(x)),
        "NaN propagation",
    )
    torch.cuda.synchronize()

    # times at the main path's shape
    x = torch.from_numpy(synth(T_MAIN, SEED)[0][:, None]).cuda()
    Tp = -(-T_MAIN // chunk) * chunk
    data_t = torch.nn.functional.pad(x.T, (0, Tp - T_MAIN)).contiguous()
    times = {
        "kernel_ms": time_ms(lambda: wavelet_cuda.maxlet_chunks_cuda(data_t)),
        "kernel_plain_ms": time_ms(lambda: wavelet_cuda.maxlet_chunks_reference(data_t)),
        "transform_ms": time_ms(lambda: wavelet_cuda.maxlet_transform_cuda(x)),
        "transform_plain_ms": time_ms(lambda: wavelet.maxlet_transform(x)),
    }
    times["max_abs_err"] = worst
    return times


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
        wavelet_cuda.maxlet_transform_cuda.launches = 0
        t0 = time.perf_counter()
        eng = runner.make_engine(data, nr_params=3, seed=SEED, records=rec)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng.run_scheme(SCHEME.split())
        eng.finalize()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = wavelet_cuda.maxlet_transform_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        sizes, counts = read_marginals(prefix + "marginals.csv")
        n_params = len(open(prefix + "parameters.csv").read().splitlines())
        n_comp = len(open(prefix + "compression.csv").read().splitlines())

    check(eng.device.type == "cuda", f"engine ran on {eng.device}")
    check(eng.ing.weights_host is None, "ingest did not take the device path")
    check(launches >= 1, "the main path never launched the maxlet kernel")
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
        "engine": eng,
    }


def map_agreement(sizes: np.ndarray, counts: np.ndarray, truth: np.ndarray) -> float:
    map_state = np.repeat(counts.argmax(axis=1), sizes)
    return max(
        float((np.asarray(perm)[map_state] == truth).mean())
        for perm in permutations(range(3))
    )


def phase_settled(eng) -> dict:
    """Settled F-phase rates and the record drain with and without the
    per-sweep streams, then kernels per sweep with the debug bitmask off and
    on, on the [main] engine (its run is over and checked)."""
    mpc = {"marginals", "parameters", "compression"}
    drains: list[float] = []
    drain = runner.Engine._drain_records

    def timed_drain(self, *args):
        t0 = time.perf_counter()
        drain(self, *args)
        drains.append(time.perf_counter() - t0)

    rates: dict = {"mpc": [], "all": []}
    drain_ms: dict = {"mpc": [], "all": []}
    old = os.environ.get("HAMMLET_DEBUG")
    with tempfile.TemporaryDirectory() as tmp:

        def run(tag: str, iters: int, profiler=None) -> None:
            eng.records = Records(
                T_MAIN, os.path.join(tmp, tag + "-"), ".csv", 3,
                outputs=mpc if tag == "mpc" else set(Records.STREAMS), overwrite=True,
            )
            drains.clear()
            if profiler is None:
                eng.run("F", iters, 4)
            else:
                with profiler:
                    eng.run("F", iters, 4)
            eng.records.close()
            rates[tag].append(iters / eng.phase_log[-1][2])
            drain_ms[tag].extend(1e3 * d for d in drains)

        runner.Engine._drain_records = timed_drain
        try:
            os.environ["HAMMLET_DEBUG"] = "0"
            run("all", 128)  # warm-up of the state stacks and the formatters
            rates["all"].clear()
            drain_ms["all"].clear()
            for tag in ("mpc", "all", "all", "mpc"):
                run(tag, 512)
            per_sweep = {}
            for flag in ("0", "1"):
                os.environ["HAMMLET_DEBUG"] = flag
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
                ])
                run("mpc", 64, prof)
                rates["mpc"].pop()
                kernels = [e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and not e.name.startswith(("Memcpy", "Memset"))]
                per_sweep[flag] = (
                    len(kernels) / 64,
                    sum(e.time_range.elapsed_us() for e in kernels) / 64e3,
                )
        finally:
            runner.Engine._drain_records = drain
            if old is None:
                del os.environ["HAMMLET_DEBUG"]
            else:
                os.environ["HAMMLET_DEBUG"] = old
    check(per_sweep["0"][0] > 0, "the profiler saw no CUDA kernel")
    check(per_sweep["1"][0] > per_sweep["0"][0],
          "HAMMLET_DEBUG=1 launched no kernel more than debug off")
    return {
        "mpc_sweeps_per_s": rates["mpc"],
        "all_sweeps_per_s": rates["all"],
        "ratio": float(np.median(rates["all"]) / np.median(rates["mpc"])),
        "mpc_drain_ms": float(np.median(drain_ms["mpc"])),
        "all_drain_ms": float(np.median(drain_ms["all"])),
        "kernels_per_sweep": per_sweep["0"][0],
        "device_ms_per_sweep": per_sweep["0"][1],
        "debug_kernels_per_sweep": per_sweep["1"][0],
        "debug_device_ms_per_sweep": per_sweep["1"][1],
    }


def phase_cli(main_rate: float) -> dict:
    """The CLI with every output stream at the main path's size."""
    data, truth = synth(T_MAIN, SEED)
    streams = ["marginals", "sequences", "parameters", "blocks", "compression",
               "mapping", "segments"]
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
                "-O", *streams, "-w"]
        cli.make_engine = spy
        wavelet_cuda.maxlet_transform_cuda.launches = 0
        try:
            rc = cli.main(argv)
        finally:
            cli.make_engine = make_engine
        launches = wavelet_cuda.maxlet_transform_cuda.launches
        check(rc == 0 and len(engines) == 1, f"cli.main returned {rc}")
        lines = {s: open(os.path.join(tmp, f"smoke-{s}.txt")).read().splitlines()
                 for s in streams}
    eng, setup_s = engines[0]
    check(eng.device.type == "cuda", f"CLI engine ran on {eng.device}")
    check(launches >= 1, "the CLI never launched the maxlet kernel")
    for s in ("sequences", "parameters", "blocks", "compression", "segments"):
        check(len(lines[s]) == N_RECORDED, f"{s}: {len(lines[s])} lines, not {N_RECORDED}")
    check(lines["mapping"] == ["0", "1", "2"], "mapping stream")
    for blk, comp in zip(lines["blocks"], lines["compression"]):
        sizes = np.array(blk.split("\t"), dtype=np.int64)
        check(int(sizes.sum()) == T_MAIN and bool((sizes > 0).all()), "blocks line")
        check(comp == f"{T_MAIN / len(sizes):.6g}", f"compression {comp} != T/{len(sizes)}")
    rows = np.array([r.split("\t") for r in lines["marginals"]], dtype=np.int64)
    sizes, counts = rows[:, 0], rows[:, 1:]
    check(int(sizes.sum()) == T_MAIN, "marginal rows do not cover T")
    check(bool((counts.sum(axis=1) == N_RECORDED).all()), "marginal row sums != 128")
    marg_bound = np.zeros(T_MAIN + 1, dtype=bool)
    marg_bound[np.cumsum(sizes)] = True
    union = np.zeros(T_MAIN + 1, dtype=bool)
    for seq, seg in zip(lines["sequences"], lines["segments"]):
        toks = np.array(seq.replace(":", "\t").split("\t"), dtype=np.int64).reshape(-1, 2)
        check(int(toks[:, 0].sum()) == T_MAIN, "sequences line does not cover T")
        check(bool((toks[1:, 1] != toks[:-1, 1]).all()), "sequences: equal adjacent states")
        bounds = np.cumsum(toks[:-1, 0])
        check(bool(marg_bound[bounds].all()), "sequence boundary not on a marginals boundary")
        union[bounds] = True
        nseg, internal = map(int, seg.split("\t"))
        check(nseg == int(union.sum()) + 1 and internal == 4 * nseg,
              f"segments {nseg} != recorded boundaries {int(union.sum())} + 1")
    check(nseg == len(sizes) == int(eng.buffers.n_boundaries) + 1, "segments vs marginals rows")
    agreement = map_agreement(sizes, counts, truth)
    check(agreement >= MAP_AGREEMENT_MIN, f"CLI MAP agreement {agreement:.4f}")
    f_sweeps = sum(n for m, n, _ in eng.phase_log if m == "F")
    f_secs = sum(t for m, _, t in eng.phase_log if m == "F")
    return {
        "launches": launches,
        "setup_s": setup_s,
        "f_sweeps_per_s": f_sweeps / f_secs,
        "ratio": f_sweeps / f_secs / main_rate,
        "map_agreement": agreement,
        "native": native.available(),
    }


def phase_resume() -> None:
    """Checkpoint -> restore -> continue is bitwise the uninterrupted run."""
    data = synth(T_RESUME, SEED + 1)[0]

    def build():
        return runner.make_engine(data, nr_params=3, seed=SEED + 1)

    whole = build()
    whole.run("M", 32, 0)
    whole.run("F", 64, 4)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resume.npz")
        cut = build()
        cut.run("M", 32, 0)
        checkpoint.save_checkpoint(cut, path)
        resumed = build()
        checkpoint.restore_checkpoint(resumed, path)
    resumed.run("F", 64, 4)
    check(resumed.device.type == "cuda", f"resume ran on {resumed.device}")
    check(torch.equal(whole.buffers.counts, resumed.buffers.counts),
          "resumed marginal counts differ from the uninterrupted run")
    check(torch.equal(whole.model.theta_mean, resumed.model.theta_mean),
          "resumed emission means differ from the uninterrupted run")
    check(int(resumed.buffers.n_records) == 16, "resumed run recorded != 16 sweeps")


def phase_debug() -> None:
    """The per-sweep invariant bitmask on the card."""
    old = os.environ.get("HAMMLET_DEBUG")
    os.environ["HAMMLET_DEBUG"] = "1"
    try:
        eng = runner.make_engine(synth(T_RESUME, SEED + 2)[0], nr_params=3, seed=SEED + 2)
        eng.run("M", 16, 0)
        eng.run("F", 16, 2)  # a healthy chunk: raises on any error bit
        mean = eng.model.theta_mean.clone()
        mean[1] = float("nan")
        eng.model = eng.model._replace(theta_mean=mean)
        try:
            eng.run("F", 4, 0)
        except FloatingPointError as exc:
            check("emission mean" in str(exc), f"wrong error: {exc}")
        else:
            raise SmokeFailure("a NaN emission mean did not raise")
    finally:
        if old is None:
            del os.environ["HAMMLET_DEBUG"]
        else:
            os.environ["HAMMLET_DEBUG"] = old


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} (cuda {torch.version.cuda}) | "
          f"{name} x{torch.cuda.device_count()}", flush=True)

    try:
        built = wavelet_cuda.build()
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] maxlet {built.path.name} in {built.seconds:.2f} s; "
              + " | ".join(ptxas), flush=True)

        k = phase_kernel()
        print(f"[kernel] bitwise equal to plain torch (card and CPU) at T in "
              f"{KERNEL_SIZES} x dim in {KERNEL_DIMS}, NaN propagates; T={T_MAIN} "
              f"dim=1: kernel {k['kernel_ms']:.4f} ms vs plain chunks "
              f"{k['kernel_plain_ms']:.4f} ms; whole transform "
              f"{k['transform_ms']:.4f} ms vs plain {k['transform_plain_ms']:.4f} ms",
              flush=True)

        m = phase_main_path()
        print(f"[main] T={T_MAIN} K=3 '{SCHEME}': setup {m['setup_s']:.3f} s, "
              f"total {m['total_s']:.3f} s, F-phase {m['f_sweeps_per_s']:.2f} sweeps/s, "
              f"capacity {m['capacity']}, last blocks {m['last_n_blocks']}, "
              f"peak device memory {m['peak_mem_bytes'] / 2**20:.1f} MiB, "
              f"MAP agreement {m['map_agreement']:.4f}, maxlet launches "
              f"{m['launches']}, phases {m['phases']}", flush=True)

        st = phase_settled(m.pop("engine"))
        print(f"[settled] T={T_MAIN} F 512 4 on the [main] engine, order m a a m: "
              f"marginals+parameters+compression {st['mpc_sweeps_per_s']} sweeps/s "
              f"(drain {st['mpc_drain_ms']:.3f} ms/chunk), all streams "
              f"{st['all_sweeps_per_s']} sweeps/s (drain {st['all_drain_ms']:.3f} "
              f"ms/chunk), median ratio {st['ratio']:.4f}; torch.profiler F 64 4: "
              f"HAMMLET_DEBUG off {st['kernels_per_sweep']} kernels/sweep, "
              f"{st['device_ms_per_sweep']:.4f} device ms/sweep; on "
              f"{st['debug_kernels_per_sweep']} kernels/sweep, "
              f"{st['debug_device_ms_per_sweep']:.4f} device ms/sweep", flush=True)

        c = phase_cli(m["f_sweeps_per_s"])
        print(f"[cli] T={T_MAIN} all 7 outputs '{SCHEME}': setup {c['setup_s']:.3f} s, "
              f"F-phase {c['f_sweeps_per_s']:.2f} sweeps/s all streams = "
              f"{c['ratio']:.3f}x the [main] rate (marginals+parameters+compression), "
              f"MAP agreement {c['map_agreement']:.4f}, maxlet launches "
              f"{c['launches']}, native formatters {c['native']}; stream checks passed",
              flush=True)

        phase_resume()
        print(f"[resume] T={T_RESUME}: M 32 0 -> checkpoint -> restore -> F 64 4 "
              "bitwise equal to the uninterrupted run (counts, emission means)",
              flush=True)

        phase_debug()
        print("[debug] HAMMLET_DEBUG=1: healthy F chunk error bits 0; NaN emission "
              "mean raised FloatingPointError", flush=True)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", flush=True)
        return 1

    print(json.dumps({"kernels": [{
        "name": "maxlet_chunk_kernel",
        "route": "cuda",
        "source": "hammlet_tpu_torch/csrc/maxlet.cu",
        "replaces": "hammlet_tpu/ops/wavelet_pallas.py:41",
        "launches": m["launches"] + c["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"],
        "plain_ms": k["kernel_plain_ms"],
    }]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
