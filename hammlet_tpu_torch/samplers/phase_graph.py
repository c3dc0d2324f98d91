"""Phase chunks as replays of captured CUDA graphs.

The port's counterpart of the JAX package's jitted ``gibbs_phase``
(hammlet_tpu/samplers/sweep.py:303-433) and ``build_sharded_phase``
(hammlet_tpu/parallel/sharded.py:449-586), and of their compile cache.
There, a chunk is one compiled program: ``lax.scan`` over the sweeps, quiet
and recording sweeps compiled apart, each sweep's key fold_in(fold_in(
master, counter), i). Here one sweep of each kind is captured on fixed
storage (sweep.PhaseSlots) and a chunk replays it: a chunk of n sweeps at
thinning t replays the quiet sweep t - 1 times, then the recording sweep,
n / t times over; a uniform chunk replays one sweep n times.

A sweep is what a *program* says it is (``OneDeviceSweep`` below for
runner.Engine, ``parallel.sharded.ShardedSweep`` for the sharded engine): a
fixed list of ``Local`` pieces, which only queue device work, and
collectives (the sharded sweep's all_gathers and all_reduce over the
processes). Each run of local pieces between two collectives is captured
as one CUDA graph. A collective is never captured: it runs eagerly between
two replays and writes into a tensor allocated once per capacity, which the
next graph reads. A sweep without collectives (one device, or a sharded
sweep in one process, where every collective is the identity) is one graph,
and the host issues one graph launch per sweep (plus the generators' seed
prologue) instead of ~400 kernel launches. Pieces hand tensors to later
pieces in a namespace; the tensors that one graph leaves there for a later
one stay referenced, so that their memory in the pool is not given to
another capture, and so do the pieces themselves, whose closures hold
tensors made before the capture that the graphs read.

One sweep and not one chunk is captured because a capture costs one sweep,
a graph holds ~400 nodes instead of a chunk's ~200k, and burn-in, whose
capacity changes almost every chunk, recaptures one sweep per kind each
time.

Graphs are keyed like the JAX ``static_argnames``: (capacity, method,
recording sweep or not, want_blocks, debug, dynamic or static threshold);
the static threshold's value lives in a slot, filled before the chunk, as
JAX passes it traced. The graphs of one capacity share one private memory
pool, and all of them are dropped when the capacity changes.

The random streams: the program owns its ``torch.Generator`` objects, and
every graph registers those its pieces draw from. Before sweep i of chunk
``counter`` the program seeds each of them (offset 0). A replay reads its
generators' seed and Philox offset when it is launched and advances the
offset by what it draws, so a generator that two graphs of one sweep draw
from carries its offset from the first to the second as in the eager
sweep, and every sweep draws exactly the bits of the fresh generators that
the plain version seeds the same way.

A capture first warms its sweep up on scratch copies of the slots on the
engine's side stream, collectives included (every process captures the
same kinds in the same order, so their collectives meet), gives the
allocator's cache back to the card where it holds more than the card has
free, then captures each run of local pieces under the process-wide
capture lock in ``thread_local`` mode. On the CPU the same pieces run eagerly on
the same slots (there is no graph to capture). On a card a failed capture
raises; nothing runs the eager loop instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

from hammlet_tpu_torch.models.hmm import HMMPriors, HMMState
from hammlet_tpu_torch.ops.blocks import PrefixStats, RankedWeights
from hammlet_tpu_torch.samplers.sweep import PhaseSlots, stream_seed, sweep_step

#: one capture at a time in the process: -M chains in threads capture on
#: their own streams, but the warm-up and the capture of one sweep kind
#: should not interleave with another's. The warm-up of a sweep with
#: collectives runs outside it: they wait for the other processes (or, in
#: a test, for the other thread ranks of this one)
_CAPTURE_LOCK = threading.RLock()


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


class Local(NamedTuple):
    """A piece of a sweep that only queues device work (no host sync, no
    collective): ``run(slots, st)`` reads the slots and the tensors earlier
    pieces left in the namespace ``st``, and writes the slots and ``st``.
    ``draws`` are the generators it draws from."""

    run: Callable[[PhaseSlots, SimpleNamespace], None]
    draws: tuple[torch.Generator, ...] = ()


#: A collective piece is any other object with ``bind(st)``, which puts its
#: fixed output tensor into ``st``, and ``__call__(st)``, which fills that
#: tensor from the other processes (eagerly) and then binds it.


def run_pieces(pieces: list, slots: PhaseSlots, st: SimpleNamespace) -> None:
    """One sweep, eagerly: every piece in order."""
    for p in pieces:
        if isinstance(p, Local):
            p.run(slots, st)
        else:
            p(st)


def runs_and_collectives(pieces: list) -> list:
    """The order a captured sweep replays in: each maximal run of local
    pieces as a list (one graph), each collective as itself."""
    out: list = []
    for p in pieces:
        if not isinstance(p, Local):
            out.append(p)
        elif out and isinstance(out[-1], list):
            out[-1].append(p)
        else:
            out.append([p])
    return out


class OneDeviceSweep:
    """The single-device sweep (samplers.sweep.sweep_step) as a program:
    one local piece, one generator seeded (seed, counter, i) for sweep i."""

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
        self.generator = torch.Generator(device=self.device)
        self.generators = (self.generator,)
        self._inputs = dict(priors=priors, ranked=ranked, prefix=prefix)
        self._static = dict(nr_params=nr_params, mapping=mapping,
                            use_self_transitions=use_self_transitions, cell_bits=cell_bits)

    def seed_sweep(self, counter: int, i: int) -> None:
        self.generator.manual_seed(stream_seed(self.seed, counter, i))

    def create_slots(self, model, buffers, rows, cand_rank, want_blocks) -> PhaseSlots:
        return PhaseSlots.create(model, buffers, rows, (cand_rank.shape[0],), want_blocks)

    def pieces(self, key: GraphKey, cand_pos, cand_rank, write_row: bool) -> list:
        step = functools.partial(
            sweep_step, self.generator, cand_pos=cand_pos, cand_rank=cand_rank,
            method=key.method, dynamic=key.dynamic, record=key.record, write_row=write_row,
            debug=key.debug, **self._inputs, **self._static,
        )
        return [Local(lambda slots, st: step(slots), (self.generator,))]


class _Captured:
    """A captured sweep: its graphs' replays and its collectives, in
    order. It holds the pieces: a graph reads, at fixed addresses, the
    tensors the pieces' closures made before the capture, and their memory
    must not go back to the allocator while the graph lives. Between two
    graphs the collectives' partials hold the namespace the graphs hand
    tensors on in; a single graph keeps none (its memory goes back to the
    pool)."""

    def __init__(self, plan: list[Callable[[], None]], pieces: list):
        self.plan, self.pieces = plan, pieces

    def __call__(self) -> None:
        for f in self.plan:
            f()


class _CapacitySet:
    """The slots and the captured sweeps of one capacity (and one set of
    record buffers and candidate arrays, which the graphs address)."""

    def __init__(self, slots: PhaseSlots, cand_pos, cand_rank, device: torch.device):
        self.slots = slots
        self.cand_pos, self.cand_rank = cand_pos, cand_rank
        self.capacity = int(cand_rank.shape[-1])
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.steps: dict[GraphKey, Callable[[], None]] = {}

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
    pieces run eagerly. ``program`` is the sweep (OneDeviceSweep,
    sharded.ShardedSweep). ``captures`` and ``capture_seconds`` count the
    sweep kinds captured (warm-up included), ``graphs`` the CUDA graphs
    those captures made (one per kind without collectives, one per run of
    local pieces with them), ``replays`` the sweeps replayed and ``chunks``
    the chunks run."""

    def __init__(self, program):
        self.program = program
        self.device = program.device
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._set: _CapacitySet | None = None
        self._snapshot = None
        self._snapshot_taken = False
        self.captures = 0
        self.capture_seconds = 0.0
        self.graphs = 0
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
            slots = self.program.create_slots(model, buffers, max(rows, 1), cand_rank, want_blocks)
            s = self._set = _CapacitySet(slots, cand_pos, cand_rank, self.device)
        return s

    def _step(self, s: _CapacitySet, key: GraphKey) -> Callable[[], None]:
        """The callable that runs one sweep of kind ``key`` on ``s``'s
        slots: graph replays (and the collectives between them) on a card,
        the pieces on the CPU."""
        fn = s.steps.get(key)
        if fn is None:
            pieces = self.program.pieces(key, s.cand_pos, s.cand_rank, write_row=key.record)
            if self._cuda:
                fn = self._capture(s, key, pieces)
            else:
                fn = functools.partial(run_pieces, pieces, s.slots, SimpleNamespace())
            s.steps[key] = fn
        return fn

    def _capture(self, s: _CapacitySet, key: GraphKey, pieces: list) -> Callable[[], None]:
        """Warm the sweep up on scratch copies of the slots on this engine's
        side stream (lazy library state must not be created inside a
        capture; the collectives allocate their outputs), then capture each
        run of local pieces on the real slots into ``s``'s pool, binding
        each collective's output between two runs. Returns the sweep: the
        graphs' replays and the collectives, in order."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        st = SimpleNamespace()
        plan: list[Callable[[], None]] = []
        order = runs_and_collectives(pieces)
        talks = len(order) > 1
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream), contextlib.nullcontext() if talks else _CAPTURE_LOCK:
            run_pieces(pieces, self._scratch(s.slots, key.record), SimpleNamespace())
            with _CAPTURE_LOCK:
                # the warm-up's transients are back in the allocator's cache, which a
                # capture cannot take from (it allocates from its own pool) and which
                # the allocator does not free while a capture is under way: where the
                # cache holds more than the card has free (at capacity ~T and K = 81)
                # the capture would find no room. Emptied only then, as it empties
                # every card's cache. (A pool of the warm-up's own, dropped here,
                # aborted the process beside other threads' warm-ups and after a
                # failed capture.)
                free = torch.cuda.mem_get_info(self.device)[0]
                if torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device) > free:
                    torch.cuda.empty_cache()
                for x in order:
                    if isinstance(x, list):
                        plan.append(self._capture_run(s, x, st))
                    else:
                        x.bind(st)
                        plan.append(functools.partial(x, st))
        main.wait_stream(self._stream)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(plan, pieces)

    def _capture_run(self, s: _CapacitySet, run: list[Local], st: SimpleNamespace):
        """Capture a run of local pieces as one graph, each generator they
        draw from registered once; returns its replay."""
        graph = torch.cuda.CUDAGraph()
        for gen in dict.fromkeys(g for p in run for g in p.draws):
            graph.register_generator_state(gen)
        graph.capture_begin(pool=s.pool, capture_error_mode="thread_local")
        try:
            for p in run:
                p.run(s.slots, st)
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        graph.capture_end()
        self.graphs += 1
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

    def _snapshot_buffers(self, buffers):
        snap = self._snapshot
        if snap is None or [t.shape for t in _fields(snap)] != [t.shape for t in _fields(buffers)]:
            snap = self._snapshot = type(buffers)(*(torch.zeros_like(t) for t in _fields(buffers)))
        return snap

    # -- the replay loop ----------------------------------------------------

    def run_chunk(
        self,
        counter: int,
        model: HMMState,
        buffers,
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
        place; the arguments and the sweeps' streams are those of the
        program's plain version (``gibbs_phase``, ``sharded_phase``), and so
        are the bytes. Returns device tensors that the next chunk
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
                for rec in sorted({record and i % thinning == thinning - 1 for i in range(n_iters)})
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
                self.program.seed_sweep(counter, i)
                kinds[record and i % thinning == thinning - 1]()
            if self._cuda:
                self.replays += n_iters
            self.chunks += 1
        blk = (slots.blk_states[:rows], slots.blk_bounds[:rows]) if want_blocks else None
        return slots.diag, slots.nbs[:rows], slots.means[:rows], slots.varis[:rows], blk

    def release(self) -> None:
        """Drop the slots, every captured sweep and the snapshot, and give
        their memory back to the card (after an out-of-memory error); the
        next chunk sets them up again. The allocator's cache is emptied
        under the capture lock: no other thread's capture is under way."""
        self._set = None
        self._snapshot = None
        self._snapshot_taken = False
        if self._cuda:
            with _CAPTURE_LOCK:
                torch.cuda.empty_cache()

    def model_copy(self) -> HMMState:
        """The last chunk's model, copied out of the slots (which the next
        chunk overwrites while a drain or a checkpoint may still read it)."""
        return HMMState(*(t.clone() for t in self._set.slots.model))

    def restore_buffers(self, buffers) -> None:
        """Copy the last recording chunk's pre-chunk snapshot back into
        ``buffers`` (an overflow replay), in place: the graphs keep their
        addresses. Nothing to do after a chunk that did not record."""
        if self._snapshot_taken:
            for dst, src in zip(_fields(buffers), _fields(self._snapshot)):
                dst.copy_(src)


def _fields(b) -> tuple[torch.Tensor, ...]:
    """The tensors of a record-buffer dataclass (sweep.RecordBuffers,
    sharded.ShardedBuffers), in field order."""
    return tuple(getattr(b, f.name) for f in dataclasses.fields(b))
