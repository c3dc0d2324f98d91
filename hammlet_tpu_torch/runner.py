"""End-to-end engine: ingest -> auto-priors -> sampling-scheme execution.

Port of hammlet_tpu/runner.py (the reference's main() pipeline,
src/main.cpp:23-477): streaming-equivalent ingest + transform, the noise
estimate, auto-priors, and the ``-i`` sampling-scheme interpreter (tokens
``P``, ``S``, ``D``, ``{F,M} iter thin``, main.cpp:391-454) driving the Gibbs
sweep on one device.

Dynamic block counts are handled with a static capacity: every sweep reports
its true block count; if a chunk overflows the capacity it is *replayed*
from the same counter-based random streams at a larger capacity, so results
are never silently truncated (burn-in chunks at the capacity ceiling
excepted, see _MAX_CAPACITY).

Ingest at T >= 2M positions runs on the device: the maxlet transform goes
through the hand-written Hopper kernels for CUDA data (ops/wavelet_cuda.py).
On a card every phase chunk of ``Engine`` runs as replays of CUDA graphs
captured per sweep kind (samplers/phase_graph.py); on the CPU the same
sweep step runs eagerly on the same fixed storage.

Run switches, as in the JAX package: HAMMLET_PHASE_CHUNK (chunk length;
also turns the capacity scaling of chunk lengths off), HAMMLET_MAX_CAPACITY
(the capacity ceiling), HAMMLET_PROFILE=<dir> (one torch.profiler trace per
phase) and HAMMLET_SETUP_TRACE (timed setup stages on stderr).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from hammlet_tpu_torch.checkpoint import save_checkpoint
from hammlet_tpu_torch.debug import check_marginal_sums, debug_enabled, raise_on_error
from hammlet_tpu_torch.device import resolve_device, synchronize, to_host
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.models.autopriors import autoprior, autoprior_host, noise_std_estimate
from hammlet_tpu_torch.models.hmm import (
    HMMPriors,
    HMMState,
    ModelSpec,
    sample_from_priors,
    threshold_host,
)
from hammlet_tpu_torch.ops.blocks import (
    DEVICE_CELL_BITS,
    PrefixStats,
    RankedWeights,
    bucket_candidates,
    build_prefix_stats,
    build_prefix_stats_device,
    build_ranked_weights,
    build_ranked_weights_device,
)
from hammlet_tpu_torch.ops.wavelet import breakpoint_weights, maxlet_transform
from hammlet_tpu_torch.ops.wavelet_cuda import maxlet_transform_cuda
from hammlet_tpu_torch.samplers.phase_graph import OneDeviceSweep, PhaseGraphs
from hammlet_tpu_torch.samplers.sweep import RecordBuffers, make_generator


def parse_scheme(tokens: list[str]) -> list[tuple]:
    """Parse the ``-i`` scheme into ops:
    ("prior",), ("static",), ("dynamic",), ("run", method, iters, thinning).
    Grammar per main.cpp:367-454."""
    n_num = sum(1 for t in tokens if t not in ("P", "S", "D", "F", "M"))
    n_meth = sum(1 for t in tokens if t in ("F", "M"))
    if n_num != 2 * n_meth:
        raise ValueError(
            'Parameters for -i, excluding "P", "S" and "D", must be multiples of 3!'
        )
    ops: list[tuple] = [("prior",)]  # samplePrior starts true (main.cpp:384)
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t == "P":
            ops.append(("prior",))
            i += 1
        elif t == "S":
            ops.append(("static",))
            i += 1
        elif t == "D":
            ops.append(("dynamic",))
            i += 1
        elif t in ("F", "M"):
            if i + 2 >= len(tokens):
                raise ValueError("Incomplete command line for -i!")
            ops.append(("run", t, int(tokens[i + 1]), int(tokens[i + 2])))
            i += 3
        else:
            raise ValueError(f"Unknown sampling type {t}!")
    return ops


#: sweeps per phase chunk (the base of the capacity scaling below): the
#: engine syncs once per chunk (overflow check, record payload) and the
#: capacity ladder moves between chunks
PHASE_CHUNK = int(os.environ.get("HAMMLET_PHASE_CHUNK", 128))

#: ceiling on the block capacity (HAMMLET_MAX_CAPACITY). The first
#: post-prior burn-in sweeps have ~T blocks, and a sweep at capacity ~T
#: allocates O(K*K*cap) transients; a burn-in chunk that overflows the
#: ceiling is ACCEPTED TRUNCATED (the sweep reduces to the top-capacity
#: ranked weights, an effectively higher threshold for those sweeps).
#: Recording chunks are never truncated.
_MAX_CAPACITY = int(os.environ.get("HAMMLET_MAX_CAPACITY", 0)) or (1 << 25)


def _scale_chunks(device: torch.device) -> bool:
    """Whether chunk lengths scale with the block capacity: on a card, as
    the JAX package does off the CPU (hammlet_tpu/runner.py:109-120), unless
    HAMMLET_PHASE_CHUNK pins the length. On the CPU a chunk costs no more
    than its sweeps, and the tests pin chunk lengths."""
    return device.type == "cuda" and "HAMMLET_PHASE_CHUNK" not in os.environ


def _chunk_for_capacity(capacity: int, scale: bool) -> int:
    """Sweeps per chunk at a block capacity: the JAX package's table.

    Every chunk costs a host sync and, when it records, a hand-off to the
    record drain, so small capacities (cheap sweeps) run long chunks; a
    huge capacity (the first burn-in sweeps, ~T blocks) runs 8-sweep chunks
    so that the capacity ladder can shrink within a few sweeps and an
    overflow replays little."""
    if capacity >= (1 << 23):
        return min(8, PHASE_CHUNK)
    if not scale:
        return PHASE_CHUNK
    if capacity <= (1 << 11):
        return 16 * PHASE_CHUNK
    if capacity <= (1 << 13):
        return 8 * PHASE_CHUNK
    if capacity <= (1 << 15):
        return 4 * PHASE_CHUNK
    if capacity <= (1 << 17):
        return 2 * PHASE_CHUNK
    return PHASE_CHUNK


def _phase_profile(device: torch.device):
    """HAMMLET_PROFILE=<dir>: torch.profiler over one phase, its trace
    written into <dir> when the phase ends (the JAX package takes one
    jax.profiler trace per phase)."""
    profile_dir = os.environ.get("HAMMLET_PROFILE")
    if not profile_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir),
    )


def _setup_tracer():
    """HAMMLET_SETUP_TRACE: a function that prints ``[setup +Ns] msg`` to
    stderr, N the seconds since this call; a no-op otherwise."""
    if not os.environ.get("HAMMLET_SETUP_TRACE"):
        return lambda msg: None
    t0 = time.time()
    return lambda msg: print(f"[setup +{time.time() - t0:.1f}s] {msg}", file=sys.stderr, flush=True)


class RecordDrain:
    """Runs the host part of each recording chunk's drain (block-size
    reconstruction, CSV formatting, writes) on one worker thread while the
    launching thread queues the next chunk's sweeps; the native formatters
    release the GIL.

    The launching thread copies each chunk's payload to the host itself, in
    chunk order, at the chunk's host sync, and keeps every collective: the
    worker only formats numpy arrays. At most one chunk is in flight:
    ``submit`` waits for the previous one first. An exception raised by a
    drain is raised again on the launching thread at its next wait.
    ``busy`` holds the worker's seconds per drain and ``waited`` the
    launching thread's seconds per wait."""

    def __init__(self):
        self._pool: ThreadPoolExecutor | None = None
        self._future: Future | None = None
        self.busy: list[float] = []
        self.waited: list[float] = []

    def submit(self, fn, *args) -> None:
        self.wait()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="hammlet-drain")
        self._future = self._pool.submit(self._timed, fn, args)

    def _timed(self, fn, args) -> None:
        t0 = time.perf_counter()
        fn(*args)
        self.busy.append(time.perf_counter() - t0)

    def wait(self) -> None:
        """Block until the pending drain is done; raise its exception."""
        future, self._future = self._future, None
        if future is not None:
            t0 = time.perf_counter()
            try:
                future.result()
            finally:
                self.waited.append(time.perf_counter() - t0)

    def close(self) -> None:
        """Wait for the pending drain, then stop the worker."""
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None


def compact_marginals(buffers: RecordBuffers) -> tuple[np.ndarray, np.ndarray]:
    """RLE-compact the marginal buffers on the device and download only the
    per-segment rows. Returns (starts, seg_counts) as host arrays; segment i
    covers [starts[i], starts[i+1]) (last ends at T); seg_counts is
    (n_seg, K)."""
    T = buffers.ever_boundary.shape[0]
    K = buffers.counts.shape[0] // T
    # decode the flat boundary-difference accumulator
    counts = torch.cumsum(buffers.counts.reshape(K, T), dim=1, dtype=torch.int32)
    first = buffers.ever_boundary.clone()
    first[0] = True
    starts = torch.nonzero(first)[:, 0]
    return (
        starts.to(torch.int32).cpu().numpy(),
        counts[:, starts].T.contiguous().cpu().numpy(),
    )


def run_scheme_resumable(engine, tokens: list[str]) -> None:
    """Execute a ``-i`` scheme on an engine, honoring the engine's scheme
    cursor: ops before ``scheme_op_index`` are skipped and a partially
    completed F/M phase continues at ``scheme_op_done`` with the original
    thinning alignment. A cursor taken under another token list is
    rejected."""
    ckpt_tokens = getattr(engine, "ckpt_scheme_tokens", None)
    if (
        engine.scheme_op_index or engine.scheme_op_done
    ) and ckpt_tokens is not None and list(ckpt_tokens) != list(tokens):
        raise ValueError(
            "checkpoint was taken under -i scheme "
            f"{' '.join(ckpt_tokens)!r} but this run uses "
            f"{' '.join(tokens)!r}; resume with the original scheme"
        )
    if engine.scheme_op_index == 0:
        engine.scheme_op_done = 0
    engine.ckpt_scheme_tokens = list(tokens)
    for idx, op in enumerate(parse_scheme(tokens)):
        if idx < engine.scheme_op_index:
            continue
        if op[0] == "prior":
            engine.sample_prior()
        elif op[0] == "static":
            engine.set_static()
        elif op[0] == "dynamic":
            engine.set_dynamic()
        else:
            _, method, iters, thin = op
            start = engine.scheme_op_done
            if start < iters:
                engine.run(method, iters - start, thin, start=start)
        engine.scheme_op_index = idx + 1
        engine.scheme_op_done = 0
    engine.scheme_op_index = 0
    engine.scheme_op_done = 0


def _next_chunk(done: int, end: int, thinning: int, max_chunk: int):
    """(n, thinning, records) for the next phase chunk.

    Recording chunks start on thinning multiples and span a multiple of the
    thinning, so the record hits land at the last sweep of each thinning
    window. Non-multiples arise only at phase edges: a resume mid-window
    runs one alignment chunk of length (thinning - done % thinning), and a
    phase tail shorter than the thinning contains no hits and runs as a
    quiet chunk."""
    remaining = end - done
    if thinning <= 0:
        return min(max_chunk, remaining), 0, False
    mis = done % thinning
    if mis:
        n_align = thinning - mis
        if n_align <= remaining:
            return n_align, n_align, True
        return remaining, 0, False  # tail: no hits left in this phase
    n_hit = (min(max_chunk, remaining) // thinning) * thinning
    if n_hit:
        return n_hit, thinning, True
    if thinning <= remaining:
        return thinning, thinning, True  # thinning wider than max_chunk
    return remaining, 0, False  # tail: no hits left


def _round_capacity(n: int) -> int:
    """Round a block count up to the next capacity bucket: a ~1.25x
    geometric ladder on multiples of 128 (per-sweep cost is roughly linear
    in capacity, so the ladder wastes <= 25%)."""
    cap = 128
    while cap < n:
        cap = -(-int(cap * 1.25) // 128) * 128
    return cap


@dataclass
class Ingest:
    """Device-resident preprocessed data."""

    weights: torch.Tensor  # (T,) float32 breakpoint weights (post multiplier)
    weights_host: np.ndarray | None  # host copy (None for device ingest)
    ranked: RankedWeights  # positions pre-sorted by weight
    prefix: PrefixStats
    coeffs_host: np.ndarray | None  # maxlet coefficients (host path only)
    noise_std: float
    T: int
    dim: int
    cell_bits: int = 16

    def count_boundaries(self, threshold: float) -> int:
        """Number of positions with weight >= ``threshold`` (float32)."""
        thr = np.float32(threshold)
        if self.weights_host is not None:
            return int((self.weights_host >= thr).sum())
        neg = self.ranked.neg_w_sorted
        value = torch.full((1,), -thr, dtype=neg.dtype, device=neg.device)
        return int(torch.searchsorted(neg, value, right=True)[0])


def host_transform(data: np.ndarray) -> tuple[np.ndarray, float, np.ndarray]:
    """(coeffs, noise_std, weights) on the host — native C++ when built,
    else the plain torch functions on the CPU (bit-identical either way)."""
    from hammlet_tpu_torch import native

    if native.available():
        coeffs = native.maxlet(data)
        noise = native.noise_std(coeffs)
        weights = native.breakpoint_weights(coeffs)
    else:
        coeffs_t = maxlet_transform(torch.from_numpy(data))
        coeffs = coeffs_t.numpy()
        noise = noise_std_estimate(coeffs)
        weights = breakpoint_weights(coeffs_t).numpy()
    return coeffs, noise, weights


def _as_2d(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.float32)
    return data[:, None] if data.ndim == 1 else data


def ingest(data: np.ndarray, weight_multiplier: float = 1.0, device=None) -> Ingest:
    """maxlet transform -> noise estimate -> breakpoint weights -> prefix
    sums (main.cpp:277-344) on the host; the results are uploaded to
    ``device`` (``resolve_device``: None is the card, or the device
    HAMMLET_TORCH_DEVICE names)."""
    device = resolve_device(device)
    data = _as_2d(data)
    T, dim = data.shape
    coeffs_host, noise, weights_host = host_transform(data)
    if weight_multiplier != 1.0:
        weights_host = weights_host * np.float32(weight_multiplier)
    return Ingest(
        weights=torch.from_numpy(weights_host).to(device),
        weights_host=weights_host,
        ranked=build_ranked_weights(weights_host, device),
        prefix=build_prefix_stats(data, device=device),
        coeffs_host=coeffs_host,
        noise_std=noise,
        T=T,
        dim=dim,
    )


def ingest_device(data: np.ndarray, weight_multiplier: float = 1.0, device=None) -> Ingest:
    """Device-side ingest: upload only the raw data and run the maxlet
    transform (the Hopper kernels for CUDA data), the noise reduction, the
    breakpoint weights, the ranking sort and the in-cell prefix sums on
    ``device`` (``resolve_device``: None is the card, or the device
    HAMMLET_TORCH_DEVICE names).
    Bit-identical maxlet coefficients and weights."""
    device = resolve_device(device)
    data = _as_2d(data)
    T, dim = data.shape
    data_dev = torch.from_numpy(data).to(device)
    coeffs = maxlet_transform_cuda(data_dev)
    # noise estimate: float32 mean of the odd-position (finest-level)
    # coefficients on the device (the reference accumulates in double — the
    # difference is far below MC noise)
    odd_mean = torch.sum(coeffs[1::2]) / (T // 2)
    weights = breakpoint_weights(coeffs)
    if weight_multiplier != 1.0:
        weights = weights * np.float32(weight_multiplier)
    return Ingest(
        weights=weights,
        weights_host=None,
        ranked=build_ranked_weights_device(weights),
        prefix=build_prefix_stats_device(data_dev, DEVICE_CELL_BITS),
        coeffs_host=None,
        noise_std=float(odd_mean) / 0.7978845608028654,
        T=T,
        dim=dim,
        cell_bits=DEVICE_CELL_BITS,
    )


class ChainOps:
    """The scheme ops, phase timing, record drain and periodic checkpoints
    that Engine and the sharded engine (parallel/sharded.ShardedEngine)
    share. A subclass provides ``T``, ``seed``, ``device``, ``priors``,
    ``model``, ``records``, ``drain`` (a RecordDrain), ``_cands`` and
    ``_cands_h``, ``phase_graphs``, ``_resize_capacity_for_phase``,
    ``_run_phase``, ``_write_records``, ``_save_checkpoint`` and
    ``_capacity_text``."""

    #: held while the engine launches a phase's sweeps. The CLI gives the
    #: -M chains it runs in threads one shared lock, so that they take turns
    #: at phases: torch releases and retakes the GIL around every op, and two
    #: eager launch loops in one process hand it over at nearly every op (a
    #: graphed engine issues a few calls per sweep). Ingest, each phase's
    #: last record drain and output run outside it.
    phase_turn = contextlib.nullcontext()

    def _next_generator(self) -> torch.Generator:
        self.sweep_counter += 1
        return make_generator(self.device, self.seed, self.sweep_counter)

    def _threshold_host(self) -> float:
        if not self._dynamic:
            return self._static_threshold
        return threshold_host(self.model.theta_var.cpu().numpy(), self.T)

    # -- scheme ops -------------------------------------------------------

    def sample_prior(self) -> None:
        self.model = sample_from_priors(self._next_generator(), self.priors)

    def set_static(self) -> None:
        self._dynamic = False
        self._static_threshold = float(self.model.threshold(self.T))

    def set_dynamic(self) -> None:
        self._dynamic = True

    def run(
        self, method: str, iterations: int, thinning: int, start: int = 0
    ) -> None:
        """One F/M phase of ``iterations`` sweeps with record thinning.
        ``start`` offsets the thinning counter when resuming a phase whose
        first ``start`` sweeps already ran. The phase's time includes the
        drain of its last recording chunk, not the wait for ``phase_turn``."""
        if iterations <= 0:
            return
        with _phase_profile(self.device), self._draining():
            with self.phase_turn:
                self._resize_capacity_for_phase()
                t0 = time.perf_counter()
                try:
                    self._run_phase(method, iterations, thinning, start)
                except torch.OutOfMemoryError as exc:
                    raise self._out_of_memory(method, exc) from exc
        synchronize(self.device)
        self.phase_log.append((method, iterations, time.perf_counter() - t0))

    def run_scheme(self, tokens: list[str]) -> None:
        run_scheme_resumable(self, tokens)

    def _out_of_memory(
        self, method: str, exc: torch.OutOfMemoryError
    ) -> torch.OutOfMemoryError:
        """The error a phase that ran out of device memory raises: it names
        the block capacity, K and HAMMLET_MAX_CAPACITY, the one setting a
        user can act on (a sweep at capacity ~T, the first after a prior
        draw, holds (K, K, capacity) float32 transients). The engine's
        captured sweeps are dropped and their memory given back to the
        card, so that the process can go on."""
        self.phase_graphs.release()
        first = str(exc).strip().splitlines()[0] if str(exc).strip() else type(exc).__name__
        return torch.OutOfMemoryError(
            f"out of device memory in an {method} phase at {self._capacity_text()} with "
            f"K = {self.spec.nr_states} states and T = {self.T} ({first}); set "
            "HAMMLET_MAX_CAPACITY to a smaller block capacity: burn-in chunks above it "
            "then run truncated, recording chunks must fit under it"
        )

    @contextlib.contextmanager
    def _draining(self):
        """A span of chunks whose record drains may overlap the next chunk:
        on the way out the last drain is waited for and the worker stopped.
        A drain's exception is raised here unless the span itself failed,
        whose exception then wins."""
        try:
            yield
        except BaseException:
            with contextlib.suppress(Exception):
                self.drain.close()
            raise
        self.drain.close()

    def _submit_drain(self, host: dict[str, np.ndarray], capacity: int) -> None:
        """Hand a chunk's host payload to the drain worker. Candidate arrays
        (fetched with the payload on a capacity's first recording chunk)
        are kept per capacity on this thread."""
        if "cand_pos" in host:
            self._cands_h[capacity] = (host.pop("cand_pos"), host.pop("cand_rank"))
        if "states" in host:
            host["cands"] = self._cands_h[capacity]
        self.drain.submit(self._write_records, self.records, host)

    def _maybe_checkpoint(self) -> None:
        """Save a checkpoint when ``checkpoint_every`` sweeps have completed
        since the last one. The pending record drain is waited for and every
        stream flushed to the disk first, so every line the checkpoint
        counts survives a kill after the save."""
        if not self.checkpoint_path or self.checkpoint_every <= 0:
            return
        if self.sweeps_completed - self._last_ckpt >= self.checkpoint_every:
            self.drain.wait()
            if self.records is not None:
                self.records.flush()
            self._save_checkpoint()
            self._last_ckpt = self.sweeps_completed

    @property
    def total_sweeps(self) -> float:
        return float(sum(n for _, n, _ in self.phase_log))

    @property
    def sample_time(self) -> float:
        return sum(secs for _, _, secs in self.phase_log)

    @property
    def sweeps_per_second(self) -> float:
        return self.total_sweeps / max(self.sample_time, 1e-9)


@dataclass
class Engine(ChainOps):
    """Single-device sampling engine. Its phase chunks run through
    ``phase_graphs`` (samplers/phase_graph.PhaseGraphs): ``_run_chunk``,
    ``_accept_chunk`` and ``_rewind_chunk`` are the whole interface, so a
    test can run the chunks through the eager ``gibbs_phase`` instead."""

    ing: Ingest
    spec: ModelSpec
    priors: HMMPriors
    seed: int
    records: Records | None = None
    capacity: int | None = None
    checkpoint_path: str | None = None
    checkpoint_every: int = 0  # sweeps between checkpoints (0 = off)
    max_capacity: int | None = None  # ceiling (None = _MAX_CAPACITY)

    model: HMMState = field(init=False)
    buffers: RecordBuffers = field(init=False)
    sweep_counter: int = field(init=False, default=0)
    sweeps_completed: int = field(init=False, default=0)
    # scheme cursor: (index of the next -i op, sweeps already done within it);
    # checkpointed so a resumed run_scheme() continues where the interrupted
    # one stopped
    scheme_op_index: int = field(init=False, default=0)
    scheme_op_done: int = field(init=False, default=0)
    last_n_blocks: int = field(init=False, default=0)
    #: one (method, sweeps, seconds) entry per run() call of this process
    #: (not checkpointed: a resumed process reports its own rate)
    phase_log: list = field(init=False, default_factory=list)

    def __post_init__(self):
        self.device = self.ing.ranked.pos_by_rank.device
        self._mapping = torch.as_tensor(
            self.spec.mapping().astype(np.int64), device=self.device
        )
        self._cands: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._cands_h: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._last_ckpt = 0
        self.drain = RecordDrain()
        self.buffers = RecordBuffers.create(
            self.ing.T, self.spec.nr_states, self.device
        )
        self.model = sample_from_priors(self._next_generator(), self.priors)
        self.phase_graphs = PhaseGraphs(OneDeviceSweep(
            self.seed, self.priors, self.ing.ranked, self.ing.prefix, self._mapping,
            nr_params=self.spec.nr_params,
            use_self_transitions=self.spec.use_self_transitions,
            cell_bits=self.ing.cell_bits,
        ))
        self._dynamic = True
        self._static_threshold = 0.0
        # explicit capacities above the default ceiling are honored
        self.max_capacity = max(
            min(self.ing.T, self.max_capacity or _MAX_CAPACITY),
            self.capacity or 0,
        )
        if self.capacity is None:
            # size for the prior-threshold block structure with headroom
            nb = self.ing.count_boundaries(self._threshold_host())
            self.capacity = min(
                self.ing.T, self.max_capacity, _round_capacity(2 * nb + 64)
            )

    @property
    def T(self) -> int:
        return self.ing.T

    def _save_checkpoint(self) -> None:
        save_checkpoint(self, self.checkpoint_path)

    def _capacity_text(self) -> str:
        return f"block capacity {self.capacity}"

    def _candidates(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Position-sorted boundary candidates for the current capacity
        (sorted once per capacity change, not per sweep)."""
        if self.capacity not in self._cands:
            self._cands[self.capacity] = bucket_candidates(
                self.ing.ranked, self.capacity
            )
        return self._cands[self.capacity]

    def _resize_capacity_for_phase(self) -> None:
        """Re-size the block capacity to the CURRENT threshold's boundary
        count at a phase boundary (both directions): a phase entered right
        after burn-in would otherwise start at the stale near-T capacity of
        the first post-prior sweeps."""
        nb = self.ing.count_boundaries(self._threshold_host())
        self.capacity = min(
            self.ing.T, self.max_capacity, _round_capacity(nb + nb // 8 + 64)
        )

    def _max_chunk(self) -> int:
        """Sweeps per chunk at the current capacity (_chunk_for_capacity)."""
        return _chunk_for_capacity(self.capacity, _scale_chunks(self.device))

    def _run_phase(
        self, method: str, iterations: int, thinning: int, start: int = 0
    ) -> None:
        recording = thinning > 0
        want_blocks = (
            recording
            and self.records is not None
            and bool({"sequences", "blocks", "segments"} & self.records.enabled)
        )
        debug = debug_enabled()
        done = start
        end = start + iterations
        while done < end:
            n, thin_s, rec_s = _next_chunk(
                done, end, thinning if recording else 0, self._max_chunk()
            )
            self.sweep_counter += 1
            counter = self.sweep_counter  # fixed across overflow replays
            while True:
                diag, nbs, means, varis, blk = self._run_chunk(
                    counter, method, n, thin_s, rec_s, want_blocks, debug
                )
                payload = self._record_payload(nbs, means, varis, blk) if rec_s else {}
                # the chunk's single host sync: [max_nb, last_nb, err] and
                # the record payload, copied in chunk order on this thread
                host = to_host(self.device, {"diag": diag, **payload})
                diag_h = host.pop("diag")
                raise_on_error(int(diag_h[2]))
                max_nb = int(diag_h[0])
                if max_nb <= self.capacity:
                    self._accept_chunk()
                    self.last_n_blocks = int(diag_h[1])
                    break
                # the device count SATURATES at capacity+1; re-price the true
                # count from the pre-chunk model's threshold so the capacity
                # grows in one jump
                max_nb = max(max_nb, self.ing.count_boundaries(self._threshold_host()))
                grown = min(
                    self.ing.T, self.max_capacity, _round_capacity(2 * max_nb)
                )
                if grown <= self.capacity:
                    # at the ceiling: burn-in chunks are accepted truncated;
                    # a recording chunk must be exact
                    if rec_s:
                        raise RuntimeError(
                            f"recording sweep needs {max_nb} blocks but the "
                            f"capacity ceiling is {self.capacity} "
                            "(HAMMLET_MAX_CAPACITY); raise the ceiling or "
                            "extend burn-in so the threshold settles first"
                        )
                    self._accept_chunk()
                    self.last_n_blocks = min(int(diag_h[1]), self.capacity)
                    break
                self.capacity = grown
                # replay the chunk (same counter) from the pre-chunk state
                # so recorded sweeps cannot double-record
                self._rewind_chunk()
            if host:
                self._submit_drain(host, self.capacity)
            done += n
            self.sweeps_completed += n
            self.scheme_op_done = done
            # shrink the capacity to track the block count (grows back via
            # replay); 12.5% headroom
            target = min(
                self.ing.T,
                self.max_capacity,
                _round_capacity(max_nb + max_nb // 8 + 64),
            )
            if target < self.capacity:
                self.capacity = target
            self._maybe_checkpoint()

    def _run_chunk(self, counter, method, n, thinning, record, want_blocks, debug):
        """One phase chunk from the engine's model and buffers at the
        current capacity, through ``phase_graphs`` (graph replays on a
        card): (diag, rec_nbs, rec_means, rec_vars, blk) as gibbs_phase
        returns them, on the device."""
        cand_pos, cand_rank = self._candidates()
        return self.phase_graphs.run_chunk(
            counter, self.model, self.buffers, cand_pos, cand_rank,
            None if self._dynamic else self._static_threshold,
            method=method, n_iters=n, thinning=thinning, record=record,
            want_blocks=want_blocks, debug=debug,
        )

    def _accept_chunk(self) -> None:
        """Take the chunk's model (a copy: the slots are overwritten by the
        next chunk); its records are already in the buffers."""
        self.model = self.phase_graphs.model_copy()

    def _rewind_chunk(self) -> None:
        """Undo an overflowed chunk before its replay: the buffers get their
        pre-chunk contents back in place (the model was never replaced)."""
        self.phase_graphs.restore_buffers(self.buffers)

    def _record_payload(self, nbs, means, varis, blk) -> dict[str, torch.Tensor]:
        """The device tensors a recording chunk's drain needs (none without
        a per-sweep stream). Block sizes never travel from the device: a
        sweep's boundary set is exactly ``cand_pos[cand_rank < n_blocks]``
        (make_blocks_bucketed) and the candidate arrays are fixed per
        capacity, so the drain rebuilds the sizes from the per-sweep block
        count; the device ships the (R, capacity) states in the smallest
        dtype that fits K, and each capacity's candidates once."""
        if self.records is None:
            return {}
        enabled = self.records.enabled
        out = {}
        if blk is not None:
            out.update(nbs=nbs, states=blk[0], bounds=blk[1])
            if self.capacity not in self._cands_h:
                out["cand_pos"], out["cand_rank"] = self._cands[self.capacity]
        elif "compression" in enabled:
            out["nbs"] = nbs
        if "parameters" in enabled:
            out.update(means=means, varis=varis)
        return out

    def _write_records(self, records: Records, h: dict[str, np.ndarray]) -> None:
        """The host part of a chunk's drain, on the drain worker: rebuild
        the block sizes and write the enabled streams."""
        if "states" in h:
            # imported here: parallel.sharded imports this module
            from hammlet_tpu_torch.parallel.sharded import _reassemble_block_rows

            pos_h, rank_h = h["cands"]
            # the P = 1, T_local = T case of the sharded drain
            states_d, sizes_d, ns_tot = _reassemble_block_rows(
                h["states"].astype(np.int32),
                h["nbs"][:, None].astype(np.int64),
                pos_h[None, :],
                rank_h[None, :],
                self.ing.T,
                self.ing.T,
            )
            records.record_sweeps_batch(states_d, sizes_d, ns_tot, h["bounds"])
        elif "nbs" in h:
            records.record_compressions(h["nbs"])
        if "means" in h:
            for m, v in zip(h["means"], h["varis"]):
                records.record_theta(m, v)

    def finalize(self) -> None:
        if self.records is not None:
            self.drain.close()
            if "marginals" in self.records.enabled:
                starts, seg_counts = compact_marginals(self.buffers)
                # save-time invariant (StateMarginals.hpp:306-308)
                check_marginal_sums(seg_counts, int(self.buffers.n_records))
                self.records.save_marginals_from_segments(starts, seg_counts)
            self.records.close()

    @property
    def marginal_counts(self) -> np.ndarray:
        """(K, T) decoded marginal state counts."""
        T = self.ing.T
        K = self.spec.nr_states
        flat = self.buffers.counts.cpu().numpy().astype(np.int64)
        return np.cumsum(flat.reshape(K, T), axis=1).astype(np.int32)

    def metrics(self) -> dict:
        """Per-run metrics under the JAX package's keys
        (hammlet_tpu/runner.py:887-899); the rate from ``phase_log``."""
        sps = self.sweeps_per_second
        return {
            "sweeps": self.sweeps_completed,
            "sweeps_per_second": sps,
            "positions_per_second": sps * self.ing.T,
            "compression_ratio": (
                self.ing.T / self.last_n_blocks if self.last_n_blocks else None
            ),
            "block_capacity": self.capacity,
            "recorded_sweeps": int(self.buffers.n_records),
        }


def make_engine(
    data: np.ndarray,
    nr_params: int = 3,
    nr_data_dim: int = 1,
    seed: int = 0,
    s2: float = 0.2,
    p: float = 0.9,
    trans: float = 0.5,
    self_trans: float = 0.5,
    initial_alpha: float = 0.5,
    weight_multiplier: float = 1.0,
    use_self_transitions: bool = True,
    records: Records | None = None,
    capacity: int | None = None,
    device_ingest: bool | None = None,
    device: str | torch.device | None = None,
) -> Engine:
    """Build a ready-to-run engine with auto-priors (the only prior mode the
    reference implements, main.cpp:204-215). ``device`` None is the card,
    or the device HAMMLET_TORCH_DEVICE names (device.resolve_device)."""
    trace = _setup_tracer()
    dev = resolve_device(device)
    if device_ingest is None:
        device_ingest = np.asarray(data).size >= 2_000_000
    ing = (
        ingest_device(data, weight_multiplier, dev)
        if device_ingest
        else ingest(data, weight_multiplier, dev)
    )
    trace(f"ingest done (device={device_ingest})")
    spec = ModelSpec(nr_params, nr_data_dim, use_self_transitions)
    if ing.weights_host is not None:
        nig_row = autoprior_host(s2, p, data, ing.weights_host, ing.noise_std)
    else:
        thr0 = float(np.sqrt(2 * np.log(float(ing.T))) * ing.noise_std)
        ap_cap = max(8, ing.count_boundaries(thr0) + 8)
        nig_row = autoprior(
            s2, p, ing.ranked, ing.prefix, ing.noise_std, ap_cap,
            cell_bits=ing.cell_bits,
        )
    trace("autoprior done")
    nig = np.tile(nig_row, (nr_params, 1))
    priors = HMMPriors.create(
        nig, spec.nr_states, trans, self_trans, initial_alpha, device=dev
    )
    eng = Engine(
        ing=ing,
        spec=spec,
        priors=priors,
        seed=seed,
        records=records,
        capacity=capacity,
    )
    trace(f"engine init done (capacity={eng.capacity})")
    return eng
