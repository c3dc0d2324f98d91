"""The Gibbs sweep and its phase loop.

Port of hammlet_tpu/samplers/sweep.py (the reference's sampleHMM loop body,
src/HMM.hpp:99-121):

    threshold -> blocks -> block stats -> state draw (FB | mixture)
    -> sweep statistics -> conjugate model resample
    -> (recording sweeps) on-device marginal recording

Block counts are dynamic and handled with a static block capacity and
masking. Every per-sweep quantity stays on the device through a phase
chunk: the engine (runner.Engine) syncs once per chunk, on ``diag``.

Per-sweep randomness comes from a ``torch.Generator`` seeded from
(seed, chunk counter, sweep index) — counter-based like the JAX package's
fold_in keys, so the engine replays an identical chunk after a capacity
overflow by passing the same counter.

A sweep runs as ``sweep_step`` on fixed storage (``PhaseSlots``): it reads
and writes only preallocated tensors, so the eager loop of ``gibbs_phase``
and the CUDA graphs of samplers/phase_graph.py run the same code.

The record buffers are updated IN PLACE (the JAX package rebuilds them
functionally): a recording chunk snapshots them once, at its start, for the
overflow replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from hammlet_tpu_torch import debug as _debug
from hammlet_tpu_torch.models.hmm import (
    HMMPriors,
    HMMState,
    SweepStats,
    resample_model,
)
from hammlet_tpu_torch.ops.blocks import (
    PrefixStats,
    RankedWeights,
    block_sufficient_stats_t,
    make_blocks_bucketed,
)
from hammlet_tpu_torch.samplers.forward_backward import fb_sample_states
from hammlet_tpu_torch.samplers.mixture import mixture_sample_states

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, counter: int, index: int = -1, shard: int | None = None) -> int:
    """63-bit generator seed for one random stream, a splitmix64 mix of
    (seed, counter, index[, shard]); index -1 is the counter's own stream
    (prior draws), index i >= 0 the i-th sweep of a chunk. ``shard`` names
    a global shard's own stream of a sharded sweep (parallel/sharded.py);
    None is the sweep's replicated stream."""
    x = 0x9E3779B97F4A7C15
    for v in (seed, counter, index) + (() if shard is None else (shard,)):
        x = (x ^ (v & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        x ^= x >> 31
        x = x * 0x94D049BB133111EB & _MASK64
        x ^= x >> 29
    return x >> 1


def make_generator(
    device: torch.device, seed: int, counter: int, index: int = -1, shard: int | None = None
) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, counter, index, shard))
    return gen


@dataclass
class RecordBuffers:
    """On-device posterior recording state.

    counts:        FLAT (K*T,) int32 — boundary-difference accumulator of the
                   per-position state counts: for every recorded block
                   [s, e) in state z, +1 at z*T+s and -1 at z*T+e; the
                   marginal counts are cumsum(counts.reshape(K, T), 1)
    ever_boundary: (T,) bool — positions that started a segment in any
                   recorded sweep (the reference's marginal segment
                   refinement, StateMarginals.hpp:51-137)
    n_records:     () int32 — number of recorded sweeps
    n_boundaries:  () int32 — running popcount of ever_boundary
    """

    counts: torch.Tensor
    ever_boundary: torch.Tensor
    n_records: torch.Tensor
    n_boundaries: torch.Tensor

    @staticmethod
    def create(T: int, K: int, device: torch.device | str = "cpu") -> "RecordBuffers":
        # torch indexes with int64, so K*T may exceed 2^31; counts are int32
        return RecordBuffers(
            counts=torch.zeros((K * T,), dtype=torch.int32, device=device),
            ever_boundary=torch.zeros((T,), dtype=torch.bool, device=device),
            n_records=torch.zeros((), dtype=torch.int32, device=device),
            n_boundaries=torch.zeros((), dtype=torch.int32, device=device),
        )

    def clone(self) -> "RecordBuffers":
        return RecordBuffers(
            self.counts.clone(), self.ever_boundary.clone(),
            self.n_records.clone(), self.n_boundaries.clone(),
        )


def state_dtype(K: int) -> torch.dtype:
    """The smallest integer dtype that holds the states 0..K-1."""
    return torch.int8 if K <= 127 else torch.int16 if K <= 32767 else torch.int32


class PhaseSlots(NamedTuple):
    """Fixed storage of a phase chunk: every tensor a sweep step reads or
    writes besides the run's constants. Shapes are the single-device
    sweep's; the sharded sweep's (parallel/sharded.py) have a shard axis
    where noted.

    model:      the chain's model, overwritten by every sweep (``copy_``)
    buffers:    the record buffers (RecordBuffers; sharded.ShardedBuffers),
                updated in place by recording sweeps
    threshold:  () float32 static threshold (not read when dynamic)
    row:        () int64 next output row; a row-writing sweep advances it
    diag:       (3,) int64 [max n_blocks, last n_blocks, OR of the error bits]
    nbs:        (R,) int64 block counts; sharded (R, P), per shard
    means, varis: (R, P) float32 output rows (P emission parameters)
    blk_states: (R, capacity) block states in ``state_dtype(K)``, or None;
                sharded (R, S, capacity)
    blk_bounds: (R,) int32 post-record ``n_boundaries``, or None
    """

    model: HMMState
    buffers: RecordBuffers
    threshold: torch.Tensor
    row: torch.Tensor
    diag: torch.Tensor
    nbs: torch.Tensor
    means: torch.Tensor
    varis: torch.Tensor
    blk_states: torch.Tensor | None
    blk_bounds: torch.Tensor | None

    @staticmethod
    def create(
        model: HMMState, buffers, rows: int, block_shape: tuple, want_blocks: bool,
        nb_shape: tuple = (),
    ) -> "PhaseSlots":
        """Slots holding a copy of ``model`` and ``rows`` output rows, each
        block count row of shape ``nb_shape``, with block stacks of shape
        ``block_shape`` per row when ``want_blocks``."""
        dev = model.theta_mean.device
        P, K = model.theta_mean.shape[0], model.pi.shape[0]
        zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        return PhaseSlots(
            model=HMMState(*(t.clone() for t in model)),
            buffers=buffers,
            threshold=zeros(),
            row=zeros(dtype=torch.int64),
            diag=zeros(3, dtype=torch.int64),
            nbs=zeros(rows, *nb_shape, dtype=torch.int64),
            means=zeros(rows, P),
            varis=zeros(rows, P),
            blk_states=zeros(rows, *block_shape, dtype=state_dtype(K)) if want_blocks else None,
            blk_bounds=zeros(rows, dtype=torch.int32) if want_blocks else None,
        )


class SweepOutputs(NamedTuple):
    """One sweep's block-level results (gibbs_sweep)."""

    states: torch.Tensor  # (Bcap,) int64 per-block states, 0 past the blocks
    sizes: torch.Tensor  # (Bcap,) int64 block sizes (0 = padding)
    n_blocks: torch.Tensor  # () int64, saturating at Bcap + 1
    threshold: torch.Tensor  # () float32 compression threshold used


def accumulate_sweep_stats(
    states: torch.Tensor,
    sizes: torch.Tensor,
    n_blocks: torch.Tensor,
    block_stats_t: torch.Tensor,
    mapping: torch.Tensor,
    nr_params: int,
) -> SweepStats:
    """Segment-reduce the sampled path into conjugate-update statistics
    (reference pass 3, ForwardBackward.hpp:170-212) as one-hot matrix
    products over the block axis (deterministic, no float atomics).
    ``block_stats_t`` is (dim, 2, B)."""
    B = states.shape[0]
    K = mapping.shape[0]
    dev = states.device
    validf = (torch.arange(B, device=dev) < n_blocks).to(torch.float32)
    sizes_f = sizes.to(torch.float32) * validf
    kk = torch.arange(K, device=dev)[:, None]
    oh = (states[None, :] == kk).to(torch.float32)  # (K, B)

    state_counts = oh @ sizes_f
    # transitions: N-1 self-transitions per block plus one prev->cur count
    # per block, prev of the first block being state 0
    diag = oh @ ((sizes.to(torch.float32) - 1.0) * validf)
    prev = torch.cat([states.new_zeros(1), states[:-1]])
    oh_prev = (prev[None, :] == kk).to(torch.float32)
    trans_counts = (oh_prev * validf[None, :]) @ oh.T + torch.diag(diag)

    # theta statistics: route each (block, dim) stat to its emission param
    pm = mapping[states]  # (B, dim)
    pp = torch.arange(nr_params, device=dev)[:, None]
    theta_sums = torch.zeros((nr_params,), dtype=torch.float32, device=dev)
    theta_sumsqs = torch.zeros_like(theta_sums)
    theta_counts = torch.zeros_like(theta_sums)
    for d in range(mapping.shape[1]):
        ohp = (pm[:, d][None, :] == pp).to(torch.float32) * validf[None, :]  # (P, B)
        theta_sums = theta_sums + ohp @ block_stats_t[d, 0]
        theta_sumsqs = theta_sumsqs + ohp @ block_stats_t[d, 1]
        theta_counts = theta_counts + ohp @ sizes_f
    return SweepStats(theta_sums, theta_sumsqs, theta_counts, trans_counts, state_counts)


def position_states(
    states: torch.Tensor, starts: torch.Tensor, n_blocks: torch.Tensor, T: int
) -> torch.Tensor:
    """Expand per-block states to per-position states, (T,). Padded starts
    (= T) mark nothing."""
    B = states.shape[0]
    valid = (torch.arange(B, device=states.device) < n_blocks).to(torch.int32)
    marks = torch.zeros((T + 1,), dtype=torch.int32, device=states.device)
    marks.index_add_(0, starts, valid)
    block_id = torch.cumsum(marks[:T], dim=0) - 1
    return states[block_id]


def record_sweep(
    buffers: RecordBuffers,
    states: torch.Tensor,
    starts: torch.Tensor,
    n_blocks: torch.Tensor,
    enabled: torch.Tensor | bool = True,
) -> RecordBuffers:
    """Fold one recorded sweep into the marginal buffers, IN PLACE.

    O(#blocks): block b in state z adds +1 at (z, starts[b]) and -1 at
    (z, starts[b+1]), the latter written as a decrement with the previous
    block's state at every block start. Masked entries (padding, or the
    whole sweep when ``enabled`` is false) add 0 at index 0. State-change
    boundaries are the block starts whose state differs from the previous
    block's; starts[b] > 0 there, so masked writes to index 0 write False
    and never race a real one."""
    T = buffers.ever_boundary.shape[0]
    B = states.shape[0]
    valid = (torch.arange(B, device=states.device) < n_blocks) & enabled
    prev = torch.cat([states.new_zeros(1), states[:-1]])
    dec_ok = valid & (starts > 0)
    idx = torch.cat([
        torch.where(valid, states * T + starts, 0),
        torch.where(dec_ok, prev * T + starts, 0),
    ])
    val = torch.cat([valid, dec_ok]).to(torch.int32)
    val[B:] *= -1
    buffers.counts.index_add_(0, idx, val)
    chg = dec_ok & (states != prev)
    # count newly-created boundaries before setting them (O(#blocks) gather)
    was_set = buffers.ever_boundary[torch.clamp(starts, max=T - 1)]
    buffers.n_boundaries += torch.sum(chg & ~was_set).to(torch.int32)
    buffers.ever_boundary.index_put_((torch.where(chg, starts, 0),), chg)
    buffers.n_records += torch.as_tensor(enabled, device=states.device).to(torch.int32)
    return buffers


def _sweep_core(
    generator: torch.Generator,
    model: HMMState,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos: torch.Tensor,  # (capacity+1,) pre-sorted bucket candidates (+ T)
    cand_rank: torch.Tensor,  # (capacity,)
    prefix: PrefixStats,
    buffers: RecordBuffers,
    threshold: torch.Tensor | None,
    *,
    method: str,
    nr_params: int,
    mapping: torch.Tensor,
    use_self_transitions: bool,
    cell_bits: int,
    record: bool,
    debug: bool = False,
    noise=None,
) -> tuple[HMMState, SweepOutputs, torch.Tensor | None]:
    """One Gibbs iteration. ``threshold`` None means dynamic (from the
    model). Returns (new model, the sweep's SweepOutputs, error bits);
    records in place when ``record``. The error bits (hammlet_tpu_torch.debug)
    are None unless ``debug``: without it the sweep issues none of their
    ops. ``noise`` replaces the state draw's Gumbels (fb_sample_states,
    mixture_sample_states); the model update still draws from
    ``generator``."""
    T = ranked.pos_by_rank.shape[0]
    capacity = cand_rank.shape[0]
    thr = model.threshold(T) if threshold is None else threshold
    blocks = make_blocks_bucketed(cand_pos, cand_rank, ranked, thr)
    bstats = block_sufficient_stats_t(prefix, blocks, cell_bits)
    # an overflowing sweep (n_blocks = capacity + 1, saturated) samples the
    # truncated structure: all capacity blocks, the last one included
    n_used = torch.clamp(blocks.n_blocks, max=capacity)
    if method == "F":
        states = fb_sample_states(
            generator, bstats, blocks.sizes, n_used,
            model.theta_mean, model.theta_var, model.A, model.pi,
            mapping, use_self_transitions, noise,
        )
    elif method == "M":
        states = mixture_sample_states(
            generator, bstats, blocks.sizes, n_used,
            model.theta_mean, model.theta_var, mapping, noise,
        )
    else:
        raise ValueError(f"unknown sampling method {method!r}")
    stats = accumulate_sweep_stats(
        states, blocks.sizes, n_used, bstats, mapping, nr_params
    )
    new_model = resample_model(generator, priors, stats)
    if record:
        # an overflowing sweep (truncated blocks) never records
        record_sweep(
            buffers, states, blocks.starts, blocks.n_blocks,
            enabled=blocks.n_blocks <= capacity,
        )
    err = None
    if debug:
        # the INPUT model is what the sweep sampled from: a poisoned
        # parameter must fail this sweep even though the conjugate resample
        # would produce a finite model again (the reference guards every
        # parameter setter, Observation.hpp:374-392)
        err = _debug.model_error_bits(model, bstats) | _debug.model_error_bits(new_model)
    return new_model, SweepOutputs(states, blocks.sizes, blocks.n_blocks, thr), err


def gibbs_sweep(
    generator: torch.Generator | None,
    model: HMMState,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos: torch.Tensor,
    cand_rank: torch.Tensor,
    prefix: PrefixStats,
    buffers: RecordBuffers,
    static_threshold: float | None = None,
    *,
    method: str,
    nr_params: int,
    mapping: torch.Tensor,
    use_self_transitions: bool = True,
    cell_bits: int = 16,
    record: bool = True,
    noise=None,
) -> tuple[HMMState, RecordBuffers, SweepOutputs]:
    """One full Gibbs iteration (HMM.hpp:99-121), the single-sweep API:
    (new model, buffers recorded in place when ``record``, SweepOutputs).
    ``static_threshold`` None is the dynamic threshold; ``noise`` as in
    _sweep_core. Phases run gibbs_phase."""
    thr = (
        None if static_threshold is None
        else torch.tensor(static_threshold, dtype=torch.float32, device=cand_pos.device)
    )
    new_model, out, _ = _sweep_core(
        generator, model, priors, ranked, cand_pos, cand_rank, prefix, buffers, thr,
        method=method, nr_params=nr_params, mapping=mapping,
        use_self_transitions=use_self_transitions, cell_bits=cell_bits,
        record=record, noise=noise,
    )
    return new_model, buffers, out


def sweep_step(
    generator: torch.Generator,
    slots: PhaseSlots,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos: torch.Tensor,
    cand_rank: torch.Tensor,
    prefix: PrefixStats,
    *,
    method: str,
    nr_params: int,
    mapping: torch.Tensor,
    use_self_transitions: bool,
    cell_bits: int,
    dynamic: bool,
    record: bool,
    write_row: bool,
    debug: bool,
) -> None:
    """One Gibbs sweep on fixed storage: the sweep samples from
    ``slots.model`` and writes the new model back into it, folds its block
    count and (with ``debug``) error bits into ``slots.diag``, records into
    ``slots.buffers`` when ``record``, and with ``write_row`` writes row
    ``slots.row`` of the output stacks (and of the block stacks, when
    ``slots`` has them and the sweep records) and advances it. The
    threshold is the model's when ``dynamic``, else ``slots.threshold``.

    No host sync, no host-to-device copy, and nothing outlives the call but
    what it writes into ``slots``: a CUDA graph can capture it
    (samplers/phase_graph.py)."""
    new_model, out, err = _sweep_core(
        generator, slots.model, priors, ranked, cand_pos, cand_rank, prefix, slots.buffers,
        None if dynamic else slots.threshold,
        method=method, nr_params=nr_params, mapping=mapping,
        use_self_transitions=use_self_transitions, cell_bits=cell_bits,
        record=record, debug=debug,
    )
    finish_sweep(
        slots, new_model, out.n_blocks, out.n_blocks, out.n_blocks, out.states, err,
        slots.buffers.n_boundaries, record=record, write_row=write_row,
    )


def finish_sweep(
    slots: PhaseSlots,
    new_model: HMMState,
    nb_max: torch.Tensor,
    nb_last: torch.Tensor,
    nb_row: torch.Tensor,
    states: torch.Tensor,
    err: torch.Tensor | None,
    n_bound: torch.Tensor,
    *,
    record: bool,
    write_row: bool,
) -> None:
    """The end of a sweep on fixed storage (sweep_step, and the sharded
    sweep's last piece): fold the block counts (``nb_max`` into the
    chunk's max, ``nb_last`` as the last) and the error bits (None without
    debug) into ``slots.diag``; with ``write_row`` write row ``slots.row``
    of the output stacks (``nb_row``, the new model's emission parameters,
    and when the slots have block stacks and the sweep records, ``states``
    and ``n_bound``, the buffers' boundary count after this sweep) and
    advance it; then write the new model into ``slots.model``."""
    diag = slots.diag
    diag[0] = torch.maximum(diag[0], nb_max)
    diag[1] = nb_last
    if err is not None:
        diag[2] = diag[2] | err
    if write_row:
        at = slots.row.view(1)
        slots.nbs.index_copy_(0, at, nb_row[None])
        slots.means.index_copy_(0, at, new_model.theta_mean[None])
        slots.varis.index_copy_(0, at, new_model.theta_var[None])
        if record and slots.blk_states is not None:
            slots.blk_states.index_copy_(0, at, states.to(slots.blk_states.dtype)[None])
            # the buffers update in place: keep this sweep's count
            slots.blk_bounds.index_copy_(0, at, n_bound.view(1))
        slots.row.add_(1)
    for dst, src in zip(slots.model, new_model):
        dst.copy_(src)


def gibbs_phase(
    seed: int,
    counter: int,
    model: HMMState,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos: torch.Tensor,
    cand_rank: torch.Tensor,
    prefix: PrefixStats,
    buffers: RecordBuffers,
    static_threshold: float | None,
    *,
    method: str,
    nr_params: int,
    mapping: torch.Tensor,
    use_self_transitions: bool,
    n_iters: int,
    thinning: int = 0,
    cell_bits: int = 16,
    record: bool = True,
    want_blocks: bool = False,
    debug: bool = False,
):
    """n_iters Gibbs sweeps with no host sync, run eagerly: the plain
    version of a chunk that the engine runs as CUDA graph replays on a card
    (samplers/phase_graph.py), through the same ``sweep_step``, with a new
    generator seeded (seed, counter, i) for sweep i.

    ``static_threshold`` None means the dynamic threshold. With ``record``
    and ``thinning`` > 0, sweep i records when i % thinning == thinning-1
    (the chunk starts on a thinning multiple; the engine aligns it).

    Returns (model, buffers, prev, diag, rec_nbs, rec_means, rec_vars,
    blk): ``prev`` is the pre-chunk snapshot of the buffers for an overflow
    replay (None when not recording); ``diag`` = [max n_blocks,
    last n_blocks, error bits] with the error bits OR-reduced over the
    chunk when ``debug`` (else 0); the rec_* stacks hold one row per
    recorded sweep (per sweep when not recording). ``blk`` is None unless
    ``want_blocks`` on a recording chunk; then it stacks, per recorded
    sweep, the (capacity,) block states in the smallest dtype that fits K
    and the post-record ``n_boundaries``. Block sizes are not stacked: the
    drain rebuilds them from the candidate arrays and the block count (a
    sweep's boundary set is ``cand_pos[cand_rank < n_blocks]``,
    make_blocks_bucketed)."""
    dev = cand_pos.device
    record = record and thinning > 0
    want_blocks = want_blocks and record
    prev = buffers.clone() if record else None
    rows = n_iters // thinning if record else n_iters
    slots = PhaseSlots.create(model, buffers, rows, (cand_rank.shape[0],), want_blocks)
    if static_threshold is not None:
        slots.threshold.fill_(static_threshold)
    for i in range(n_iters):
        rec = record and i % thinning == thinning - 1
        sweep_step(
            make_generator(dev, seed, counter, i), slots, priors, ranked,
            cand_pos, cand_rank, prefix,
            method=method, nr_params=nr_params, mapping=mapping,
            use_self_transitions=use_self_transitions, cell_bits=cell_bits,
            dynamic=static_threshold is None, record=rec, write_row=rec or not record,
            debug=debug,
        )
    blk = (slots.blk_states, slots.blk_bounds) if want_blocks else None
    return slots.model, buffers, prev, slots.diag, slots.nbs, slots.means, slots.varis, blk
