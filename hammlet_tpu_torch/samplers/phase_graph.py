"""Phase chunks as replays of captured CUDA graphs.

The port's counterpart of the JAX package's jitted ``gibbs_phase``
(hammlet_tpu/samplers/sweep.py:303-433) and its compile cache. There, a
chunk is one compiled program: ``lax.scan`` over the sweeps, quiet and
recording sweeps compiled apart, each sweep's key fold_in(fold_in(master,
counter), i). Here one sweep of each kind is captured as a CUDA graph on
fixed storage (sweep.PhaseSlots) and a chunk replays it: a chunk of n
sweeps at thinning t replays the quiet graph t - 1 times, then the
recording graph, n / t times over; a uniform chunk replays one graph n
times. The host then issues one graph launch per sweep (plus the
generator's two-fill seed prologue) instead of ~400 kernel launches.

One sweep and not one chunk is captured because a capture costs one sweep,
a graph holds ~400 nodes instead of a chunk's ~200k, and burn-in, whose
capacity changes almost every chunk, recaptures one sweep per kind each
time.

Graphs are keyed like the JAX ``static_argnames``: (capacity, method,
recording sweep or not, want_blocks, debug, dynamic or static threshold);
the static threshold's value lives in a slot, filled before the chunk, as
JAX passes it traced. The graphs of one capacity share one private memory
pool, and all of them are dropped when the capacity changes.

The random stream: one ``torch.Generator`` per engine, registered with
every graph. Before replay i of chunk ``counter`` the engine seeds it with
``stream_seed(seed, counter, i)``: a replay reads the generator's seed and
Philox offset (0 after a seed) when it is launched, so it draws exactly the
bits of the fresh generator the eager ``gibbs_phase`` seeds the same way.

On the CPU the same sweep step runs eagerly on the same slots (there is no
graph to capture). On a card a failed capture raises; nothing runs the
eager loop instead.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import NamedTuple

import torch

from hammlet_tpu_torch.models.hmm import HMMPriors, HMMState
from hammlet_tpu_torch.ops.blocks import PrefixStats, RankedWeights
from hammlet_tpu_torch.samplers.sweep import (
    PhaseSlots,
    RecordBuffers,
    stream_seed,
    sweep_step,
)

#: one capture at a time in the process: -M chains in threads capture on
#: their own streams, but the warm-up and the capture of one sweep kind
#: should not interleave with another's
_CAPTURE_LOCK = threading.Lock()


class GraphKey(NamedTuple):
    """What a captured sweep depends on besides the slots' contents."""

    capacity: int
    method: str
    record: bool
    want_blocks: bool
    debug: bool
    dynamic: bool


def graph_key(
    capacity: int, method: str, record: bool, want_blocks: bool, debug: bool, dynamic: bool
) -> GraphKey:
    """The cache key of one sweep kind: only a recording sweep writes
    block stacks, so a quiet sweep's key carries no ``want_blocks``."""
    record = bool(record)
    return GraphKey(int(capacity), method, record, bool(want_blocks) and record,
                    bool(debug), bool(dynamic))


class _CapacitySet:
    """The slots and the captured sweeps of one capacity (and one set of
    record buffers and candidate arrays, which the graphs address)."""

    def __init__(self, slots: PhaseSlots, cand_pos, cand_rank, device: torch.device):
        self.slots = slots
        self.cand_pos, self.cand_rank = cand_pos, cand_rank
        self.capacity = int(cand_rank.shape[0])
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.steps: dict[GraphKey, object] = {}

    def fits(self, buffers, cand_pos, cand_rank, rows: int, want_blocks: bool) -> bool:
        s = self.slots
        return (
            self.cand_pos is cand_pos and self.cand_rank is cand_rank
            and all(a is b for a, b in zip(_fields(s.buffers), _fields(buffers)))
            and s.nbs.shape[0] >= rows
            and (s.blk_states is not None or not want_blocks)
        )


class PhaseGraphs:
    """The phase chunks of one engine, on fixed storage: on a card as
    replays of CUDA graphs captured per sweep kind, on the CPU as the same
    sweep step run eagerly. ``captures`` and ``capture_seconds`` count the
    captures (warm-up included), ``replays`` the graph launches, ``chunks``
    the chunks run."""

    def __init__(
        self,
        seed: int,
        priors: HMMPriors,
        ranked: RankedWeights,
        prefix: PrefixStats,
        mapping: torch.Tensor,
        *,
        nr_params: int,
        use_self_transitions: bool,
        cell_bits: int,
    ):
        self.device = ranked.pos_by_rank.device
        self.seed = seed
        self._inputs = (priors, ranked)
        self._prefix = prefix
        self._static = dict(nr_params=nr_params, mapping=mapping,
                            use_self_transitions=use_self_transitions, cell_bits=cell_bits)
        self.generator = torch.Generator(device=self.device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._set: _CapacitySet | None = None
        self._snapshot: RecordBuffers | None = None
        self._snapshot_taken = False
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.chunks = 0

    # -- the cache ----------------------------------------------------------

    def cached_keys(self) -> list[GraphKey]:
        """Keys of the sweeps captured (on the CPU: set up) for the current
        capacity; every other capacity's are dropped."""
        return [] if self._set is None else list(self._set.steps)

    def _capacity_set(self, model, buffers, cand_pos, cand_rank, rows, want_blocks) -> _CapacitySet:
        s = self._set
        if s is None or not s.fits(buffers, cand_pos, cand_rank, rows, want_blocks):
            # drop the old graphs (and with them their pool) first
            self._set = None
            slots = PhaseSlots.create(model, buffers, max(rows, 1), cand_rank.shape[0], want_blocks)
            s = self._set = _CapacitySet(slots, cand_pos, cand_rank, self.device)
        return s

    def _step(self, s: _CapacitySet, key: GraphKey):
        """The callable that runs one sweep of kind ``key`` on ``s``'s
        slots: a captured graph's replay on a card, the step on the CPU."""
        fn = s.steps.get(key)
        if fn is None:
            make = functools.partial(
                sweep_step, self.generator, priors=self._inputs[0], ranked=self._inputs[1],
                cand_pos=s.cand_pos, cand_rank=s.cand_rank, prefix=self._prefix,
                method=key.method, dynamic=key.dynamic, record=key.record,
                write_row=key.record, debug=key.debug, **self._static,
            )
            fn = self._capture(s, key, make) if self._cuda else functools.partial(make, s.slots)
            s.steps[key] = fn
        return fn

    def _capture(self, s: _CapacitySet, key: GraphKey, make):
        """Warm the step up on scratch copies of the slots on this engine's
        side stream (lazy library state must not be created inside a
        capture), then capture it on the real slots into ``s``'s pool."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with _CAPTURE_LOCK:
            scratch = self._scratch(s.slots, key.record)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                make(scratch)
                graph.capture_begin(pool=s.pool, capture_error_mode="thread_local")
                try:
                    make(s.slots)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            main.wait_stream(self._stream)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return graph.replay

    def _scratch(self, slots: PhaseSlots, record: bool) -> PhaseSlots:
        """Copies of ``slots`` for a warm-up, writing row 0 (the slots' row
        is wherever the last chunk left it): a quiet sweep never touches the
        buffers; a recording one writes the snapshot buffers, which hold
        nothing yet (a chunk takes its snapshot after its captures)."""
        copy = lambda t: None if t is None else t.clone()  # noqa: E731
        return slots._replace(
            model=HMMState(*(t.clone() for t in slots.model)),
            buffers=self._snapshot_buffers(slots.buffers) if record else slots.buffers,
            row=torch.zeros_like(slots.row),
            **{f: copy(getattr(slots, f)) for f in PhaseSlots._fields
               if f not in ("model", "buffers", "row")},
        )

    def _snapshot_buffers(self, buffers: RecordBuffers) -> RecordBuffers:
        snap = self._snapshot
        if snap is None or snap.counts.shape != buffers.counts.shape:
            snap = self._snapshot = RecordBuffers.create(
                buffers.ever_boundary.shape[0], buffers.counts.shape[0] // buffers.ever_boundary.shape[0],
                self.device,
            )
        return snap

    # -- the replay loop ----------------------------------------------------

    def run_chunk(
        self,
        counter: int,
        model: HMMState,
        buffers: RecordBuffers,
        cand_pos: torch.Tensor,
        cand_rank: torch.Tensor,
        static_threshold: float | None,
        *,
        method: str,
        n_iters: int,
        thinning: int,
        record: bool,
        want_blocks: bool,
        debug: bool,
    ):
        """One phase chunk from ``model``, recording into ``buffers`` in
        place; the arguments and the sweeps' streams are ``gibbs_phase``'s,
        and so are the bytes. Returns device tensors that the next chunk
        overwrites: (diag, rec_nbs, rec_means, rec_vars, blk), the rec_*
        stacks one row per recorded sweep (no rows when not recording), blk
        None unless ``want_blocks`` on a recording chunk. The new model is
        ``model_copy()``; ``restore_buffers`` undoes a recording chunk."""
        record = record and thinning > 0
        want_blocks = want_blocks and record
        rows = n_iters // thinning if record else 0
        with torch.cuda.device(self.device) if self._cuda else contextlib.nullcontext():
            s = self._capacity_set(model, buffers, cand_pos, cand_rank, rows, want_blocks)
            dynamic = static_threshold is None
            kinds = {
                rec: self._step(s, graph_key(s.capacity, method, rec, want_blocks, debug, dynamic))
                for rec in {record and i % thinning == thinning - 1 for i in range(n_iters)}
            }
            slots = s.slots
            for dst, src in zip(slots.model, model):
                dst.copy_(src)
            slots.diag.zero_()
            slots.row.zero_()
            if not dynamic:
                slots.threshold.fill_(static_threshold)
            self._snapshot_taken = record
            if record:
                snap = self._snapshot_buffers(buffers)
                for dst, src in zip(_fields(snap), _fields(buffers)):
                    dst.copy_(src)
            for i in range(n_iters):
                self.generator.manual_seed(stream_seed(self.seed, counter, i))
                kinds[record and i % thinning == thinning - 1]()
            if self._cuda:
                self.replays += n_iters
            self.chunks += 1
        blk = (slots.blk_states[:rows], slots.blk_bounds[:rows]) if want_blocks else None
        return slots.diag, slots.nbs[:rows], slots.means[:rows], slots.varis[:rows], blk

    def model_copy(self) -> HMMState:
        """The last chunk's model, copied out of the slots (which the next
        chunk overwrites while a drain or a checkpoint may still read it)."""
        return HMMState(*(t.clone() for t in self._set.slots.model))

    def restore_buffers(self, buffers: RecordBuffers) -> None:
        """Copy the last recording chunk's pre-chunk snapshot back into
        ``buffers`` (an overflow replay), in place: the graphs keep their
        addresses. Nothing to do after a chunk that did not record."""
        if self._snapshot_taken:
            for dst, src in zip(_fields(buffers), _fields(self._snapshot)):
                dst.copy_(src)


def _fields(b: RecordBuffers) -> tuple[torch.Tensor, ...]:
    return b.counts, b.ever_boundary, b.n_records, b.n_boundaries
