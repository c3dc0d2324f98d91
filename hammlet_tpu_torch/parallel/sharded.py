"""Position-sharded Gibbs sweep over a PositionMesh.

Port of hammlet_tpu/parallel/sharded.py. The position axis is cut into P
shards of T_local positions; each of W processes holds P / W consecutive
shards on its one device as a leading local-shard axis (parallel/mesh.py).
Each sweep exchanges only O(P * K^2) values between shards:

- block boundaries: each shard thresholds its local weights; a block whose
  start lies in shard k extends to the first boundary of any later shard,
  found from an all_gather of P per-shard first-boundary positions. Block
  *identity* is exactly the single-device (= reference) partition; blocks
  are never split at shard edges.
- block statistics: fully local via the cell-structured prefix sums (shard
  sizes are cell-aligned and each shard holds one extra R entry for its
  right edge), plus the all-gathered per-shard "head" statistics for blocks
  spanning shards.
- forward pass: local prefix scans of K x K block matrices, then a
  cross-shard prefix over the P gathered shard-total matrices.
- backward pass: local random-map suffix compositions, then a cross-shard
  suffix over the P gathered shard-total maps; the final state is drawn
  identically on every process from the replicated stream.
- sweep statistics are all_gathered and summed in shard order, one sum
  over the same (P, ...) rows on every process (the counterpart of the JAX
  package's ``_osum``, sharded.py:339-353: an all_reduce's float reduction
  order depends on the transport)
  and the conjugate model update runs replicated (same stream -> the same
  new model on every process, with no broadcast).

Every cross-shard quantity is computed for all P shards from the replicated
gathers, and each process then takes its own rows, so the arithmetic does
not depend on how the shards are spread over processes: 1 x 4 and 2 x 2
write the same bytes.

Randomness: sweep i of chunk ``counter`` draws the last-state Gumbels and
the model update from one replicated generator, (seed, counter, i), and the
per-block Gumbels of each shard from that global shard's own generator,
(seed, counter, i, shard) — the counterpart of JAX's k_z / k_model and
fold_in(k_local, shard) (sharded.py:223-224). The draws do not depend on W.

The sweep is a fixed list of local pieces and, between them, the
collectives (ShardedSweep). On a card the engine's chunks replay CUDA
graphs (samplers/phase_graph.py): one graph per sweep kind in one process,
where every collective is the identity, else one graph per run of local
pieces, each collective issued eagerly between two replays into a tensor
kept per capacity. ``sharded_phase`` runs the same pieces eagerly: it is
the plain version the tests hold the graphs against.

The marginal count buffers stay sharded with the position axis, so a 3 Gbp
genome's counts never materialize on one device.

Layout: T is padded to T_pad = P * T_local with T_local a multiple of the
prefix-cell size; padding weights are -inf (never boundaries) and padded
data is zero, so the block partition of [0, T) is untouched and padding
positions belong to no block.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from hammlet_tpu_torch import debug as _debug
from hammlet_tpu_torch import runner
from hammlet_tpu_torch.device import to_host
from hammlet_tpu_torch.checkpoint import save_sharded_checkpoint
from hammlet_tpu_torch.io.records import Records
from hammlet_tpu_torch.models.autopriors import nig_autoprior
from hammlet_tpu_torch.models.distributions import emission_log_weights_t, gumbel
from hammlet_tpu_torch.models.hmm import (
    HMMPriors,
    HMMState,
    ModelSpec,
    SweepStats,
    resample_model,
    sample_from_priors,
)
from hammlet_tpu_torch.parallel.ingest import sharded_ingest
from hammlet_tpu_torch.parallel.mesh import PositionMesh, position_mesh
from hammlet_tpu_torch.samplers.forward_backward import (
    prefix_matmul_scan_t,
    suffix_compose_scan_t,
)
from hammlet_tpu_torch.samplers.phase_graph import (
    GraphKey,
    Local,
    PhaseGraphs,
    graph_key,
    run_pieces,
)
from hammlet_tpu_torch.samplers.sweep import (
    PhaseSlots,
    accumulate_sweep_stats,
    finish_sweep,
    stream_seed,
)


@dataclass
class ShardedBuffers:
    """On-device recording state of this process's S shards (the sharded
    counterpart of samplers.sweep.RecordBuffers), updated in place.

    counts: (S, K*T_local) int32 — per-shard FLAT boundary-difference
            accumulators; the marginals are the cumsum along the global
            position axis, with the carry across shard edges
    everb:  (S, T_local + 1) bool — per-shard union of recorded segment
            starts; column T_local takes the masked writes
    n_rec, n_bound: () int32 — recorded sweeps and the popcount of the
            global boundary union, replicated
    """

    counts: torch.Tensor
    everb: torch.Tensor
    n_rec: torch.Tensor
    n_bound: torch.Tensor

    @staticmethod
    def create(S: int, K: int, T_local: int, device) -> "ShardedBuffers":
        return ShardedBuffers(
            counts=torch.zeros((S, K * T_local), dtype=torch.int32, device=device),
            everb=torch.zeros((S, T_local + 1), dtype=torch.bool, device=device),
            n_rec=torch.zeros((), dtype=torch.int32, device=device),
            n_bound=torch.zeros((), dtype=torch.int32, device=device),
        )

    def clone(self) -> "ShardedBuffers":
        return ShardedBuffers(
            self.counts.clone(), self.everb.clone(), self.n_rec.clone(), self.n_bound.clone()
        )


class _Layout(NamedTuple):
    """Shard-layout constants of a capacity's sweeps."""

    sidx: torch.Tensor  # (S,) local shard index
    gid: torch.Tensor  # (S,) global index of each local shard
    start: torch.Tensor  # (S,) first global position of each local shard
    ids: torch.Tensor  # (P,) every global shard index
    later: torch.Tensor  # (P, P) bool: shard j (column) after shard g (row)
    earlier: torch.Tensor  # (P, P) bool: shard j before shard g
    bidx: torch.Tensor  # (cap,) block slot index
    rows: slice  # this process's rows of a (P, ...) array


def _layout(mesh: PositionMesh, cap: int, T_local: int, device) -> _Layout:
    ids = torch.arange(mesh.n_shards, device=device)
    gid = ids[mesh.first_shard : mesh.first_shard + mesh.local_shards]
    return _Layout(
        sidx=gid - mesh.first_shard,
        gid=gid,
        start=gid * T_local,
        ids=ids,
        later=ids[None, :] > ids[:, None],
        earlier=ids[None, :] < ids[:, None],
        bidx=torch.arange(cap, device=device),
        rows=slice(mesh.first_shard, mesh.first_shard + mesh.local_shards),
    )


class _Gather:
    """A collective piece of the sweep (phase_graph's protocol): for each
    (src, dst) name pair, ``st.dst`` = the all_gather of ``st.src`` over
    the processes, written into a tensor allocated on the first call and
    kept, which the next graph reads."""

    def __init__(self, mesh: PositionMesh, *pairs: tuple[str, str]):
        self.mesh, self.pairs = mesh, pairs
        self.outs: list[torch.Tensor] | None = None

    def bind(self, st: SimpleNamespace) -> None:
        if self.outs is None:
            w = self.mesh.world_size
            self.outs = [
                torch.empty((w * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
                for x in (getattr(st, src) for src, _ in self.pairs)
            ]
        for (_, dst), out in zip(self.pairs, self.outs):
            setattr(st, dst, out)

    def __call__(self, st: SimpleNamespace) -> None:
        self.bind(st)
        for (src, _), out in zip(self.pairs, self.outs):
            self.mesh.all_gather_into(out, getattr(st, src))


class _Psum:
    """A collective piece: ``st.dst`` = the integer sum of ``st.src`` over
    the processes, in a tensor allocated on the first call and kept."""

    def __init__(self, mesh: PositionMesh, src: str, dst: str):
        self.mesh, self.src, self.dst = mesh, src, dst
        self.out: torch.Tensor | None = None

    def bind(self, st: SimpleNamespace) -> None:
        x = getattr(st, self.src)
        if self.out is None:
            self.out = torch.empty((x.numel(),), dtype=x.dtype, device=x.device)
        setattr(st, self.dst, self.out.view(x.shape))

    def __call__(self, st: SimpleNamespace) -> None:
        self.bind(st)
        self.mesh.psum_into(self.out, getattr(st, self.src))


def _identity(*pairs: tuple[str, str]) -> Local:
    """What a collective is without a process group: ``st.dst`` is
    ``st.src``, inside the graph."""

    def run(slots, st):
        for src, dst in pairs:
            setattr(st, dst, getattr(st, src))

    return Local(run)


class ShardedSweep:
    """One sharded Gibbs sweep over this process's shards (the counterpart
    of the JAX body under shard_map, sharded.py:79-403) as a program of
    samplers/phase_graph.py: a fixed list of local pieces and, between
    them, the collectives, which the graphs leave out. Per sweep: the
    gathers of the shards' first boundaries, head statistics and block
    counts; on the F method the gathers of the shard-total forward
    matrices and backward maps; the gather of each shard's last state; the
    gather of the per-shard sweep statistics (the first half of their sum
    in shard order); on a recording sweep the integer sum of
    the new boundaries. Without a process group each collective is the
    identity, a local piece, and the whole sweep is one graph. The plain
    version, ``sharded_phase``, runs the same pieces eagerly.

    The generators: ``generator``, replicated, seeded (seed, counter, i)
    for sweep i, draws the last-state Gumbels and the model update; one per
    local shard, seeded (seed, counter, i, global shard), draws that
    shard's per-block Gumbels. The replicated one draws in two graphs of a
    sweep; its Philox offset carries from the first to the second."""

    def __init__(
        self,
        mesh: PositionMesh,
        seed: int,
        priors: HMMPriors,
        negw: torch.Tensor,  # (S, T_local) ascending sort of -weights per shard
        r_t: torch.Tensor,  # (dim, 2, S, T_local+1) in-cell reverse prefix rows
        q2_hi: torch.Tensor,  # (n_cells+1, dim, 2) cell prefix, high part
        q2_lo: torch.Tensor,  # low part
        *,
        T: int,
        T_local: int,
        cell_bits: int,
        mapping: torch.Tensor,
        nr_params: int,
        use_self_transitions: bool,
    ):
        self.mesh, self.seed, self.priors = mesh, seed, priors
        self.device = mesh.device
        self.negw, self.r_t = negw, r_t
        # (2, dim, 2, n_cells+1) stacked (hi, lo) cell prefix
        self.q2c = torch.stack([q2_hi.permute(1, 2, 0), q2_lo.permute(1, 2, 0)])
        self.T, self.T_local, self.cell_bits = T, T_local, cell_bits
        self.mapping, self.nr_params = mapping, nr_params
        self.use_self_transitions = use_self_transitions
        self.generator = torch.Generator(device=self.device)
        self.shard_generators = tuple(torch.Generator(device=self.device) for _ in mesh.local_ids)
        self.generators = (self.generator, *self.shard_generators)

    def seed_sweep(self, counter: int, i: int) -> None:
        self.generator.manual_seed(stream_seed(self.seed, counter, i))
        for g, gen in zip(self.mesh.local_ids, self.shard_generators):
            gen.manual_seed(stream_seed(self.seed, counter, i, shard=g))

    def create_slots(self, model, buffers, rows, cand_rank, want_blocks) -> PhaseSlots:
        return PhaseSlots.create(model, buffers, rows, tuple(cand_rank.shape), want_blocks,
                                 nb_shape=(self.mesh.n_shards,))

    def _gather(self, *pairs: tuple[str, str]):
        return _identity(*pairs) if self.mesh.group is None else _Gather(self.mesh, *pairs)

    def _check_ranks_agree(self, key: GraphKey, write_row: bool) -> None:
        """Every process must build (and, on a card, warm up and capture)
        the same sweep kinds in the same order, or their collectives would
        pair up wrongly: compare the kind over the processes."""
        mine = torch.tensor(
            [key.capacity, "FM".index(key.method), key.record, key.want_blocks, key.debug,
             key.dynamic, write_row], device=self.device,
        )
        every = self.mesh.all_gather(mine[None])
        if not bool((every == mine).all()):
            raise RuntimeError(f"the processes build different sweeps: {every.tolist()}")

    def pieces(
        self, key: GraphKey, cand_pos: torch.Tensor, cand_rank: torch.Tensor, write_row: bool,
        noise=None,
    ) -> list:
        """The sweep of kind ``key`` on the per-shard candidates
        (cand_pos (S, cap+1) position-sorted, + T_local; cand_rank (S, cap)
        local weight ranks), as pieces. A recording sweep records in place
        into ``slots.buffers`` unless a shard overflows the capacity; with
        ``write_row`` it writes a row of the slots' stacks. ``noise``
        replaces the draws of the per-block Gumbels: (K, S, cap) for "M",
        (last-state Gumbels (K,), map Gumbels (K, K, S, cap)) for "F"; the
        model update still draws from ``generator``. No piece waits for the
        host."""
        if key.method not in ("F", "M"):
            raise ValueError(f"unknown sampling method {key.method!r}")
        mesh, T, T_local, cell_bits = self.mesh, self.T, self.T_local, self.cell_bits
        mapping, negw, r_t, q2c = self.mapping, self.negw, self.r_t, self.q2c
        if mesh.group is not None:
            self._check_ranks_agree(key, write_row)
        S, cap = cand_rank.shape
        dim = r_t.shape[0]
        K = mapping.shape[0]
        dev = negw.device
        lay = _layout(mesh, cap, T_local, dev)  # once per sweep kind and capacity
        start = lay.start
        end = start + T_local
        rows = lay.rows
        # what a gather sends must be contiguous; without a group the
        # gather is the identity and the views go on as they are
        send = (lambda x: x) if mesh.group is None else torch.Tensor.contiguous  # noqa: E731

        def query_t(s_glob, e_glob):
            """Block stats for global [s, e) with both endpoints in
            [start, end] of their shard: (S, B) -> (dim, 2, S, B)."""
            B = s_glob.shape[1]
            ls = (s_glob - start[:, None])[None, None].expand(dim, 2, S, B)
            le = (e_glob - start[:, None])[None, None].expand(dim, 2, S, B)
            r_s = torch.gather(r_t, 3, ls)
            r_e = torch.gather(r_t, 3, le)
            qd = q2c[..., e_glob >> cell_bits] - q2c[..., s_glob >> cell_bits]  # (2, dim, 2, S, B)
            return (r_s - r_e) + (qd[0] + qd[1])

        def boundaries(slots, st):
            """Local block boundaries (pre-sorted bucket candidates: a
            saturating masked count + a masked compaction, exact whenever
            the sweep fits cap, the only case whose count is used), and what
            the other shards need of them."""
            thr = slots.model.threshold(T) if key.dynamic else slots.threshold
            st.nb_l = nb_l = torch.sum(negw[:, : min(cap + 1, T_local)] <= -thr, dim=1)  # (S,)
            valid_c = cand_rank < nb_l[:, None]
            slot = torch.where(valid_c, torch.cumsum(valid_c, dim=1) - 1, cap)
            sel = torch.full((S, cap + 1), cap, dtype=torch.int64, device=dev)
            sel.scatter_(1, slot, lay.bidx.expand(S, cap))
            st.lstarts = torch.gather(cand_pos, 1, sel[:, :cap])  # padded -> T_local
            st.gstarts = st.lstarts + start[:, None]  # padded -> shard end
            st.valid_b = lay.bidx < nb_l[:, None]
            st.is_last_real = lay.bidx == (nb_l - 1)[:, None]
            st.first_b = torch.where(nb_l > 0, st.gstarts[:, 0], T)
            head_end = torch.clamp(torch.minimum(st.first_b, end), min=start, max=end)
            head_stat = query_t(start[:, None], head_end[:, None])[..., 0]  # (dim, 2, S)
            st.heads = send(head_stat.permute(2, 0, 1))

        def block_stats(slots, st):
            """Cross-shard values for every shard from the replicated
            gathers, then this process's rows (the same (P, ...) arithmetic
            whatever W is); block statistics: every block as if it ended
            inside its shard (the last real one cut at the shard end), plus
            the gathered heads of the shards the last block spans; then the
            emission log-weights, (K, S, cap), block axis minor."""
            next_all = torch.amin(torch.where(lay.later, st.firsts_all[None, :], T), dim=1)
            include = lay.later & (lay.ids[None, :] * T_local < next_all[:, None])
            tail_all = torch.sum(
                torch.where(include[:, :, None, None], st.heads_all[None], 0.0), dim=1
            )
            next_boundary = next_all[rows]
            gends_next = torch.cat([st.gstarts[:, 1:], end[:, None]], dim=1)
            gends = torch.where(st.is_last_real, next_boundary[:, None], gends_next)
            st.sizes = gends - st.gstarts  # padded blocks: end - end = 0
            bstats = query_t(st.gstarts, torch.minimum(gends, end[:, None]))  # (dim, 2, S, cap)
            spans = st.is_last_real & (gends > end[:, None])
            st.bstats = bstats + torch.where(
                spans[None, None], tail_all[rows].permute(1, 2, 0)[..., None], 0.0
            )
            st.log_e = emission_log_weights_t(
                st.bstats.reshape(dim, 2, S * cap), st.sizes.reshape(-1),
                slots.model.theta_mean, slots.model.theta_var, mapping,
            ).reshape(K, S, cap)

        def mixture_states(slots, st):
            g = noise if noise is not None else torch.stack(
                [gumbel(gen, (K, cap), dev) for gen in self.shard_generators], dim=1
            )
            st.z = torch.where(st.valid_b, torch.argmax(st.log_e + g, dim=0), 0)

        def forward(slots, st):
            """Local prefix scans of the K x K block matrices; each shard's
            total goes to the others."""
            model = slots.model
            st.sizes_f = st.sizes.to(torch.float32)
            st.log_a_ss = torch.log(torch.diagonal(model.A))
            E = st.log_e
            if self.use_self_transitions:
                E = E + (st.sizes_f[None] - 1.0) * st.log_a_ss[:, None, None]
            e_w = torch.exp(E - torch.amax(E, dim=0, keepdim=True))
            M = model.A[:, :, None, None] * e_w[None]  # (K, K, S, cap)
            eye = torch.eye(K, dtype=M.dtype, device=dev)
            M = torch.where(st.valid_b[None, None], M, eye[:, :, None, None])
            st.L = prefix_matmul_scan_t(M)
            st.tots = send(st.L[..., -1].permute(2, 0, 1))  # (S, K, K)

        def backward(slots, st):
            """The cross-shard prefix over the P gathered shard totals, the
            forward columns, the last state (drawn identically on every
            process from the replicated stream) and the local random-map
            suffix compositions; each shard's composed map goes to the
            others."""
            model = slots.model
            eye = torch.eye(K, dtype=st.L.dtype, device=dev)
            # cross-shard inclusive prefix products over the P shard totals
            tot_prefix = prefix_matmul_scan_t(st.tots_all.permute(1, 2, 0))  # (K, K, P)
            pre_all = torch.cat([eye[:, :, None], tot_prefix[:, :, :-1]], dim=2)
            v_pre = torch.sum(model.pi[:, None, None] * pre_all, dim=0)[:, rows]  # (K, S)
            alpha = torch.sum(v_pre[:, None, :, None] * st.L, dim=0)  # (K, S, cap)
            alpha = alpha / torch.clamp(torch.sum(alpha, dim=0, keepdim=True), min=1e-35)
            v_last = torch.sum(model.pi[:, None] * tot_prefix[:, :, -1], dim=0)
            last_col = v_last / torch.clamp(torch.sum(v_last), min=1e-35)

            m_star = torch.amax(torch.where(st.nb_all > 0, lay.ids, -1))
            is_global_last = (lay.gid[:, None] == m_star) & st.is_last_real  # (S, cap)
            if self.use_self_transitions:
                scale = torch.exp((st.sizes_f[None] - 1.0) * st.log_a_ss[:, None, None])
                cols = torch.where(is_global_last[None], alpha, alpha * scale)
            else:
                cols = alpha

            if noise is None:
                g_last = gumbel(self.generator, (K,), dev)
                g_maps = torch.stack(
                    [gumbel(gen, (K, K, cap), dev) for gen in self.shard_generators], dim=2
                )
            else:
                g_last, g_maps = noise
            st.z_last = torch.argmax(torch.log(torch.clamp(last_col, min=1e-38)) + g_last).reshape(1)
            logits = (
                torch.log(torch.clamp(cols, min=1e-38))[:, None]
                + torch.log(torch.clamp(model.A, min=1e-38))[:, :, None, None]
            )  # (i, j, S, cap)
            pred = torch.argmax(logits + g_maps, dim=0)  # (j, S, cap)
            ident = torch.arange(K, device=dev)[:, None]
            maps = torch.where((st.valid_b & ~is_global_last)[None], pred, ident[:, :, None])
            st.r_suffix = suffix_compose_scan_t(maps)  # (K, S, cap)
            st.tmaps = send(st.r_suffix[:, :, 0].T)  # (S, K)

        def fb_states(slots, st):
            """The cross-shard suffix: column g composes the maps of shards
            g..P-1; a shard enters through the composition of every LATER
            shard."""
            ident = torch.arange(K, device=dev)[:, None]
            suffix_all = suffix_compose_scan_t(st.tmaps_all.T)  # (K, P)
            after = torch.cat([suffix_all[:, 1:], ident], dim=1)[:, rows]  # (K, S)
            entry = torch.index_select(after, 0, st.z_last)  # (1, S)
            st.z = torch.gather(st.r_suffix, 0, entry[:, :, None].expand(1, S, cap))[0]

        def last_state(slots, st):
            """Each shard's last block state: the chain state entering a
            shard is that of the highest earlier shard with any blocks."""
            nb_l = st.nb_l
            st.last_state = torch.where(
                nb_l > 0, torch.gather(st.z, 1, torch.clamp(nb_l - 1, 0, cap - 1)[:, None])[:, 0], 0
            )

        def sweep_stats(slots, st):
            """The sweep statistics per shard, their shard-order sum's
            input (S, 3 P + K^2 + K)."""
            jbest = torch.amax(
                torch.where(lay.earlier & (st.nb_all[None, :] > 0), lay.ids[None, :], -1), dim=1
            )
            st.carry = torch.where(jbest >= 0, st.last_all[torch.clamp(jbest, min=0)], 0)[rows]
            # one call over the S local rows: each row is summed on its own,
            # in one fixed order, so the bytes do not depend on S (or W)
            loc = accumulate_sweep_stats(st.z, st.sizes, st.nb_l, st.bstats, mapping, self.nr_params)
            # accumulate_sweep_stats took state 0 as the previous state of a
            # shard's first block; replace it with the carried state
            # (one-hot arithmetic on integer-valued counts: exact, no indexed add)
            kk = torch.arange(K, device=dev)
            moved = (st.carry[:, None] == kk).to(torch.float32) - (kk == 0).to(torch.float32)
            first = (st.z[:, 0, None] == kk) & (st.nb_l > 0)[:, None]  # (S, K)
            trans = loc.trans_counts + moved[:, :, None] * first[:, None, :]
            st.stats_l = torch.cat(
                [loc.theta_sums, loc.theta_sumsqs, loc.theta_counts, trans.reshape(S, K * K),
                 loc.state_counts], dim=1,
            )

        def update(slots, st):
            """The ordered sum's second half (one sum over the gathered
            (P, ...) rows, the same on every process), the replicated model
            update, and the recording: +1 at each local block start with its
            state, -1 with the previous state (a shard's first block takes
            the carried state, which also closes the block spanning in from
            earlier shards)."""
            tot = torch.sum(st.stats_all, dim=0)
            n_p = self.nr_params
            st.stats = SweepStats(
                theta_sums=tot[:n_p],
                theta_sumsqs=tot[n_p : 2 * n_p],
                theta_counts=tot[2 * n_p : 3 * n_p],
                trans_counts=tot[3 * n_p : 3 * n_p + K * K].reshape(K, K),
                state_counts=tot[3 * n_p + K * K :],
            )
            st.new_model = resample_model(self.generator, self.priors, st.stats)
            if not key.record:
                return
            buffers, z = slots.buffers, st.z
            rec = torch.amax(st.nb_all) <= cap  # an overflowing sweep never records
            z_prev = torch.cat([st.carry[:, None], z[:, :-1]], dim=1)
            valid_s = st.valid_b & (st.gstarts < T) & rec
            dec_ok = valid_s & (st.gstarts > 0)
            lstarts, sidx = st.lstarts, lay.sidx
            base = (sidx * (K * T_local))[:, None]
            idx = torch.cat([
                torch.where(valid_s, z * T_local + lstarts, 0) + base,
                torch.where(dec_ok, z_prev * T_local + lstarts, 0) + base,
            ], dim=1)
            val = torch.cat([valid_s.to(torch.int32), -dec_ok.to(torch.int32)], dim=1)
            buffers.counts.view(-1).index_add_(0, idx.reshape(-1), val.reshape(-1))
            chg = dec_ok & (z != z_prev)
            # count newly-created boundaries before setting them
            was_set = torch.gather(buffers.everb, 1, torch.clamp(lstarts, max=T_local - 1))
            st.newly = torch.sum(chg & ~was_set)
            everb_idx = torch.where(chg, lstarts, T_local) + (sidx * (T_local + 1))[:, None]
            buffers.everb.view(-1).index_fill_(0, everb_idx.reshape(-1), True)
            buffers.n_rec += rec.to(torch.int32)

        def finish(slots, st):
            buffers = slots.buffers
            if key.record:
                buffers.n_bound += st.newly_all.to(torch.int32)
            err = None
            if key.debug:
                # the input model too: a poisoned parameter must fail the
                # sweep that sampled from it (Observation.hpp:374-392 setter
                # guards)
                err = (_debug.model_error_bits(slots.model, st.bstats)
                       | _debug.model_error_bits(st.new_model))
            finish_sweep(
                slots, st.new_model, torch.amax(st.nb_all), torch.sum(st.nb_all), st.nb_all,
                st.z, err, buffers.n_bound, record=key.record, write_row=write_row,
            )

        out = [
            Local(boundaries),
            self._gather(("first_b", "firsts_all"), ("heads", "heads_all"), ("nb_l", "nb_all")),
            Local(block_stats),
        ]
        if key.method == "M":
            out.append(Local(mixture_states, self.shard_generators))
        else:
            out += [
                Local(forward),
                self._gather(("tots", "tots_all")),
                Local(backward, self.generators),
                self._gather(("tmaps", "tmaps_all")),
                Local(fb_states),
            ]
        out += [
            Local(last_state),
            self._gather(("last_state", "last_all")),
            Local(sweep_stats),
            self._gather(("stats_l", "stats_all")),
            Local(update, (self.generator,)),
        ]
        if key.record:
            out.append(_identity(("newly", "newly_all")) if mesh.group is None
                       else _Psum(mesh, "newly", "newly_all"))
        out.append(Local(finish))
        return out


def _or_over_processes(mesh: PositionMesh, err: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of a () integer error bitmask over the processes (each
    checks only its own shards' block statistics)."""
    if mesh.group is None:
        return err
    errs = mesh.all_gather(err.reshape(1))  # (W,)
    bits = 2 ** torch.arange(8, device=err.device, dtype=err.dtype)
    return torch.sum(((errs[:, None] & bits) != 0).any(dim=0) * bits).to(err.dtype)


def sharded_phase(
    mesh: PositionMesh,
    seed: int,
    counter: int,
    model: HMMState,
    priors: HMMPriors,
    negw: torch.Tensor,
    candpos: torch.Tensor,
    candrank: torch.Tensor,
    r_t: torch.Tensor,
    q2_hi: torch.Tensor,
    q2_lo: torch.Tensor,
    buffers: ShardedBuffers,
    static_threshold: float | None,
    *,
    method: str,
    T: int,
    T_local: int,
    cell_bits: int,
    mapping: torch.Tensor,
    nr_params: int,
    use_self_transitions: bool,
    n_iters: int,
    thinning: int = 0,
    record: bool = True,
    want_blocks: bool = False,
    debug: bool = False,
):
    """A chunk of n_iters sharded sweeps with no host sync, run eagerly:
    the plain version of the chunks the engine runs as CUDA graph replays
    (samplers/phase_graph.py), through the same ShardedSweep pieces, with
    fresh slots and the generators seeded for each sweep as the graphs'
    are (the counterpart of build_sharded_phase, sharded.py:449, as
    samplers.sweep.gibbs_phase is of the JAX gibbs_phase).

    With ``record`` and ``thinning`` > 0, sweep i records when
    i % thinning == thinning - 1. Returns (model, buffers, prev, diag,
    rec_nbs, rec_means, rec_vars, blk): ``prev`` is the pre-chunk snapshot
    of the buffers for an overflow replay (None when not recording);
    ``diag`` = [max per-shard block count, last sweep's total block count,
    error bits OR-reduced over the chunk and the processes]; rec_nbs is
    (rows, P), one row per recorded sweep (per sweep when not recording).
    ``blk`` is None unless ``want_blocks`` on a recording chunk; then it
    stacks per recorded sweep this process's (S, cap) states in the
    smallest dtype that fits K, and the post-record n_bound. Block sizes do
    not travel: the drain rebuilds them from the candidates."""
    record = record and thinning > 0
    want_blocks = want_blocks and record
    prev = buffers.clone() if record else None
    program = ShardedSweep(
        mesh, seed, priors, negw, r_t, q2_hi, q2_lo, T=T, T_local=T_local, cell_bits=cell_bits,
        mapping=mapping, nr_params=nr_params, use_self_transitions=use_self_transitions,
    )
    rows = n_iters // thinning if record else n_iters
    slots = program.create_slots(model, buffers, rows, candrank, want_blocks)
    if static_threshold is not None:
        slots.threshold.fill_(static_threshold)
    kinds: dict[bool, list] = {}
    for i in range(n_iters):
        rec = record and i % thinning == thinning - 1
        if rec not in kinds:
            key = graph_key(candrank.shape[1], method, rec, want_blocks, debug,
                            static_threshold is None)
            kinds[rec] = program.pieces(key, candpos, candrank, write_row=rec or not record)
        program.seed_sweep(counter, i)
        run_pieces(kinds[rec], slots, SimpleNamespace())
    diag = slots.diag
    if debug:
        diag[2] = _or_over_processes(mesh, diag[2])
    blk = (slots.blk_states, slots.blk_bounds) if want_blocks else None
    return slots.model, buffers, prev, diag, slots.nbs, slots.means, slots.varis, blk


def _local_segment_gather(
    counts_s: torch.Tensor, everb_s: torch.Tensor, K: int, T_local: int, is_first: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode one shard's boundary-diff buffer and gather the counts at its
    segment starts (sharded.py:590): (n_seg,) local starts and (n_seg, K)
    counts, without the carries of earlier shards."""
    cum = torch.cumsum(counts_s.view(K, T_local), dim=1, dtype=torch.int32)
    first = everb_s.clone()
    if is_first:
        first[0] = True
    starts_l = torch.nonzero(first)[:, 0]
    return starts_l, cum[:, starts_l].T


def compact_sharded_marginals(engine) -> tuple[np.ndarray, np.ndarray]:
    """RLE-compact the sharded marginal accumulators on the device and
    download only per-segment rows (the reference keeps its marginal store
    small, StateMarginals.hpp:20-21).

    One small replicated summary ((P,) segment counts + (P, K) shard
    totals) gives every process the cross-shard count carries; each process
    then gathers its own shards' rows at their segment starts, and in a
    multi-process run the rows are exchanged once, padded only to the
    largest process payload (sharded.py:607). Every process must call it.

    Returns (starts, seg_counts): global segment start positions (ascending
    int64) and the (n_seg, K) recorded counts at those starts."""
    mesh = engine.mesh
    K = engine.spec.nr_states
    T_local = engine.T_local
    S = mesh.local_shards
    buf = engine.buffers
    everb = buf.everb[:, :T_local]
    gid = torch.tensor(list(mesh.local_ids), device=everb.device)
    # global position 0 starts a segment
    n_seg_l = torch.sum(everb, dim=1) + (gid == 0)
    tots_l = torch.sum(buf.counts.view(S, K, T_local), dim=2, dtype=torch.int64)
    n_seg = mesh.all_gather(n_seg_l).cpu().numpy().astype(np.int64)  # (P,)
    tots = mesh.all_gather(tots_l).cpu().numpy()  # (P, K)
    carries = np.concatenate([np.zeros((1, K), np.int64), np.cumsum(tots, axis=0)[:-1]])

    parts = []  # (n_j, 2 + K) int32: [shard, local start, counts...]
    for s, j in enumerate(mesh.local_ids):
        if n_seg[j] == 0:
            continue
        starts_l, seg = _local_segment_gather(buf.counts[s], everb[s], K, T_local, j == 0)
        parts.append(torch.cat([
            torch.full((len(starts_l), 1), j, dtype=torch.int32, device=everb.device),
            starts_l.to(torch.int32)[:, None],
            seg,
        ], dim=1))
    mine = torch.cat(parts) if parts else torch.empty(
        (0, 2 + K), dtype=torch.int32, device=everb.device
    )
    if mesh.world_size > 1:
        pad = int(n_seg.reshape(mesh.world_size, S).sum(axis=1).max())
        sent = torch.full((pad, 2 + K), -1, dtype=torch.int32, device=everb.device)
        sent[: len(mine)] = mine
        rows = mesh.all_gather(sent).cpu().numpy()
        rows = rows[rows[:, 0] >= 0]
    else:
        rows = mine.cpu().numpy()
    order = np.lexsort((rows[:, 1], rows[:, 0]))  # global shard-major order
    rows = rows[order]
    starts = rows[:, 0].astype(np.int64) * T_local + rows[:, 1]
    seg_counts = rows[:, 2:].astype(np.int64) + carries[rows[:, 0]]
    return starts, seg_counts


def _reassemble_block_rows(
    z_h: np.ndarray,
    nbs_h: np.ndarray,
    pos_h: np.ndarray,
    rank_h: np.ndarray,
    T: int,
    T_local: int,
):
    """Reassemble a chunk's per-shard block rows into global block order,
    reconstructing block sizes from the static candidate arrays.

    z_h: (R, P*cap) per-recorded-sweep state stacks where shard j's valid
    blocks occupy [j*cap, j*cap + nbs_h[r, j]); pos_h (P, cap+1) and
    rank_h (P, cap) are the host copies of the per-shard candidates. A
    sweep's shard-j boundary positions are pos_h[j][rank_h[j] < nb] +
    j*T_local (ascending, mirroring the device compaction), and the global
    sizes are the diffs of the concatenated starts with a final T sentinel
    — which also merges blocks spanning shard edges exactly as the device
    does (the last block of a shard ends at the next shard's first
    boundary). Returns dense (R, max_total) states/sizes plus per-row
    totals for Records.record_sweeps_batch.

    The reconstruction runs in the native batch routine when the C++
    library is built (native/ingest.cpp:hammlet_reassemble_blocks); the
    NumPy fallback caches the candidate selection per (shard, nb) since
    block counts repeat across sweeps once the threshold settles."""
    from hammlet_tpu_torch import native

    R, P = nbs_h.shape
    cap = z_h.shape[1] // P
    z3 = z_h.reshape(R, P, cap)
    res = native.reassemble_blocks(z3, nbs_h, pos_h, rank_h, T, T_local)
    if res is not None:
        return res
    ns = nbs_h.sum(axis=1).astype(np.int64)
    maxn = int(ns.max()) if R else 0
    states = np.zeros((R, maxn), dtype=np.int32)
    sizes = np.zeros((R, maxn), dtype=np.int32)
    sel_cache: dict[tuple[int, int], np.ndarray] = {}
    for r_i in range(R):
        parts_pos: list[np.ndarray] = []
        parts_z: list[np.ndarray] = []
        for j in range(P):
            nb = int(nbs_h[r_i, j])
            if nb:
                key = (j, nb)
                if key not in sel_cache:
                    sel_cache[key] = (
                        pos_h[j, :-1][rank_h[j] < nb].astype(np.int64)
                        + j * T_local
                    )
                parts_pos.append(sel_cache[key])
                parts_z.append(z3[r_i, j, :nb])
        if not parts_pos:
            continue
        gstarts = np.concatenate(parts_pos)
        n_r = int(ns[r_i])
        states[r_i, :n_r] = np.concatenate(parts_z)
        sizes[r_i, :n_r] = np.diff(np.append(gstarts, T))
    return states, sizes, ns


@dataclass
class ShardedEngine(runner.ChainOps):
    """Multi-shard engine mirroring runner.Engine with position sharding
    (sharded.py:775). Every process of the mesh runs the same calls in the
    same order: the capacity decisions come from replicated values. Its
    phase chunks run through ``phase_graphs`` (samplers/phase_graph.
    PhaseGraphs over a ShardedSweep): ``_run_chunk``, ``_accept_chunk`` and
    ``_rewind_chunk`` are the whole interface, so a test can run the chunks
    through the eager ``sharded_phase`` instead."""

    mesh: PositionMesh
    spec: ModelSpec
    priors: HMMPriors
    seed: int
    T: int
    T_local: int
    cell_bits: int
    negw: torch.Tensor  # (S, T_local) per-shard ascending sort of -weights
    rank: torch.Tensor  # (S, T_local) per-shard weight rank -> local position
    r_t: torch.Tensor  # (dim, 2, S, T_local+1) per-shard local R rows
    q2_hi: torch.Tensor
    q2_lo: torch.Tensor
    records: Records | None = None
    cap_local: int = 1024
    checkpoint_path: str | None = None
    checkpoint_every: int = 0  # sweeps between checkpoints (0 = off)

    model: HMMState = field(init=False)
    buffers: ShardedBuffers = field(init=False)
    sweep_counter: int = field(init=False, default=0)
    sweeps_completed: int = field(init=False, default=0)
    scheme_op_index: int = field(init=False, default=0)
    scheme_op_done: int = field(init=False, default=0)
    last_n_blocks: int = field(init=False, default=0)
    #: one (method, sweeps, seconds) entry per run() call of this process
    phase_log: list = field(init=False, default_factory=list)

    def __post_init__(self):
        self.n_shards = self.mesh.n_shards
        self.device = self.mesh.device
        K = self.spec.nr_states
        if K * self.T_local >= 2**31:
            # the checkpoint's flat per-shard index (and the JAX package's)
            # is int32
            raise ValueError(
                f"per-shard marginal index K*T_local = {K}*{self.T_local} "
                "exceeds int32; use more shards"
            )
        self._mapping = torch.as_tensor(
            self.spec.mapping().astype(np.int64), device=self.device
        )
        self._cands: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._cands_h: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._last_ckpt = 0
        self.drain = runner.RecordDrain()
        self.buffers = ShardedBuffers.create(
            self.mesh.local_shards, K, self.T_local, self.device
        )
        self.model = sample_from_priors(self._next_generator(), self.priors)
        self.phase_graphs = PhaseGraphs(ShardedSweep(
            self.mesh, self.seed, self.priors, self.negw, self.r_t, self.q2_hi, self.q2_lo,
            T=self.T, T_local=self.T_local, cell_bits=self.cell_bits, mapping=self._mapping,
            nr_params=self.spec.nr_params, use_self_transitions=self.spec.use_self_transitions,
        ))
        self._dynamic = True
        self._static_threshold = 0.0
        # per-shard capacity ceiling (runner._MAX_CAPACITY): burn-in chunks
        # overflowing it are accepted truncated
        self.max_cap_local = max(
            min(self.T_local, runner._MAX_CAPACITY), self.cap_local
        )

    def _shard_candidates(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-shard position-sorted candidates for the current cap_local
        (sorted once per capacity change, not per sweep)."""
        cap = self.cap_local
        if cap not in self._cands:
            prefix = self.rank[:, :cap]
            order = torch.argsort(prefix, dim=1)  # positions are distinct
            pos = torch.cat(
                [torch.gather(prefix, 1, order), prefix.new_full((len(prefix), 1), self.T_local)],
                dim=1,
            )
            self._cands[cap] = (pos, order)
        return self._cands[cap]

    def _price_nb(self, thr: float) -> int:
        """Worst-shard boundary count at a threshold (a per-shard binary
        search; off the sweep path)."""
        value = torch.full(
            (self.mesh.local_shards, 1), -np.float32(thr), dtype=torch.float32,
            device=self.device,
        )
        per_shard = torch.searchsorted(self.negw, value, right=True)[:, 0]
        return int(self.mesh.all_gather(per_shard).max())

    def _capacity_text(self) -> str:
        return f"block capacity {self.cap_local} per shard"

    def _resize_capacity_for_phase(self) -> None:
        """Re-size cap_local to the CURRENT threshold's worst-shard boundary
        count at a phase boundary (both directions), as
        runner.Engine._resize_capacity_for_phase."""
        nb = self._price_nb(self._threshold_host())
        self.cap_local = min(
            self.T_local, self.max_cap_local, runner._round_capacity(nb + nb // 8 + 64)
        )

    def _run_phase(self, method: str, iterations: int, thinning: int, start: int = 0) -> None:
        recording = thinning > 0
        want_blocks = (
            recording
            and self.records is not None
            and bool({"sequences", "blocks", "segments"} & self.records.enabled)
        )
        debug = _debug.debug_enabled()
        done = start
        end = start + iterations
        while done < end:
            n, thin_s, rec_s = runner._next_chunk(
                done, end, thinning if recording else 0,
                runner._chunk_for_capacity(self.cap_local, runner._scale_chunks(self.device)),
            )
            self.sweep_counter += 1
            counter = self.sweep_counter  # fixed across overflow replays
            while True:
                diag, nbs, means, varis, blk = self._run_chunk(
                    counter, method, n, thin_s, rec_s, want_blocks, debug
                )
                payload = self._record_payload(nbs, means, varis, blk) if rec_s else {}
                # the chunk's single host sync: [max_nb, last total, err] and
                # the record payload, copied in chunk order on this thread
                host = to_host(self.device, {"diag": diag, **payload})
                diag_h = host.pop("diag")
                _debug.raise_on_error(int(diag_h[2]))
                max_nb = int(diag_h[0])
                self.last_n_blocks = int(diag_h[1])
                if max_nb <= self.cap_local:
                    self._accept_chunk()
                    break
                # per-shard counts saturate at cap_local+1: re-price the true
                # worst-shard count at the pre-chunk threshold for a
                # one-jump capacity grow
                max_nb = max(max_nb, self._price_nb(self._threshold_host()))
                grown = min(
                    self.T_local, self.max_cap_local, runner._round_capacity(2 * max_nb)
                )
                if grown <= self.cap_local:
                    # at the per-shard ceiling: burn-in chunks are accepted
                    # truncated; a recording chunk must be exact
                    if rec_s:
                        raise RuntimeError(
                            f"recording sweep needs {max_nb} blocks on its "
                            f"worst shard but the capacity ceiling is "
                            f"{self.cap_local} (HAMMLET_MAX_CAPACITY); raise the "
                            "ceiling or extend burn-in"
                        )
                    self._accept_chunk()
                    break
                self.cap_local = grown
                # replay the chunk (same counter) from the pre-chunk state
                self._rewind_chunk()
            if host:
                self._submit_drain(host, self.cap_local)
            done += n
            self.sweeps_completed += n
            self.scheme_op_done = done
            # track the falling block count after burn-in (grows back via
            # same-counter replay on overflow)
            target = min(
                self.T_local, self.max_cap_local,
                runner._round_capacity(max_nb + max_nb // 8 + 64),
            )
            if target < self.cap_local:
                self.cap_local = target
            self._maybe_checkpoint()

    def _run_chunk(self, counter, method, n, thinning, record, want_blocks, debug):
        """One phase chunk from the engine's model and buffers at the
        current capacity, through ``phase_graphs`` (graph replays on a
        card): (diag, rec_nbs, rec_means, rec_vars, blk) as sharded_phase
        returns them, on the device; the error bits are OR-reduced over the
        processes after the chunk, outside the graphs."""
        candpos, candrank = self._shard_candidates()
        diag, *out = self.phase_graphs.run_chunk(
            counter, self.model, self.buffers, candpos, candrank,
            None if self._dynamic else self._static_threshold,
            method=method, n_iters=n, thinning=thinning, record=record,
            want_blocks=want_blocks, debug=debug,
        )
        if debug:
            diag[2] = _or_over_processes(self.mesh, diag[2])
        return (diag, *out)

    def _accept_chunk(self) -> None:
        """Take the chunk's model (a copy: the slots are overwritten by the
        next chunk); its records are already in the buffers."""
        self.model = self.phase_graphs.model_copy()

    def _rewind_chunk(self) -> None:
        """Undo an overflowed chunk before its replay: the buffers get their
        pre-chunk contents back in place (the model was never replaced)."""
        self.phase_graphs.restore_buffers(self.buffers)

    def _record_payload(self, nbs, means, varis, blk) -> dict[str, torch.Tensor]:
        """The device tensors a recording chunk's drain needs (see
        _reassemble_block_rows for the size-free block reconstruction).
        The gathers of every process's state stacks and, once per capacity,
        candidates are collectives: they run here, on the launching thread,
        at the same point on every process; only the primary's Records
        writes."""
        if self.records is None:
            return {}
        enabled = self.records.enabled
        out = {}
        if blk is not None:
            out.update(nbs=nbs, states=self.mesh.all_gather(blk[0].transpose(0, 1)), bounds=blk[1])
            if self.cap_local not in self._cands_h:
                pos, rank = self._cands[self.cap_local]
                out["cand_pos"] = self.mesh.all_gather(pos)
                out["cand_rank"] = self.mesh.all_gather(rank)
        elif "compression" in enabled:
            out["nbs"] = nbs
        if "parameters" in enabled:
            out.update(means=means, varis=varis)
        return out

    def _write_records(self, records: Records, h: dict[str, np.ndarray]) -> None:
        """The host part of a chunk's drain, on the drain worker."""
        if "states" in h:
            nbs_h = h["nbs"]  # (R, P)
            z_h = h["states"].transpose(1, 0, 2).reshape(len(nbs_h), -1)  # (P, R, cap) -> (R, P*cap)
            pos_h, rank_h = h["cands"]
            states, sizes, ns_tot = _reassemble_block_rows(
                z_h.astype(np.int32), nbs_h, pos_h, rank_h, self.T, self.T_local
            )
            records.record_sweeps_batch(states, sizes, ns_tot, h["bounds"])
        elif "nbs" in h:
            records.record_compressions(h["nbs"].sum(axis=1))
        if "means" in h:
            for m, v in zip(h["means"], h["varis"]):
                records.record_theta(m, v)

    def _save_checkpoint(self) -> None:
        """A collective: every process reaches it after the same chunk."""
        save_sharded_checkpoint(self, self.checkpoint_path)

    def _one_sweep(self, method: str, do_record: bool) -> None:
        """One sweep as its own chunk (test and debug surface; phases run
        chunked), recorded into the streams when ``do_record``."""
        with self._draining():
            self._run_phase(method, 1, 1 if do_record else 0)

    def finalize(self) -> None:
        if self.records is not None:
            self.drain.close()
            if "marginals" in self.records.enabled:
                starts, seg_counts = compact_sharded_marginals(self)
                # save-time invariant (StateMarginals.hpp:306-308)
                _debug.check_marginal_sums(seg_counts, int(self.buffers.n_rec))
                self.records.save_marginals_from_segments(starts, seg_counts)
            self.records.close()

    def metrics(self) -> dict:
        """Per-run metrics under the JAX package's keys
        (hammlet_tpu/parallel/sharded.py:1289); the rate from ``phase_log``."""
        sps = self.sweeps_per_second
        return {
            "sweeps": self.total_sweeps,
            "sweeps_per_second": sps,
            "positions_per_second": sps * self.T,
            "positions_per_second_per_chip": sps * self.T / self.n_shards,
            "n_devices": self.n_shards,
            "block_capacity_per_shard": self.cap_local,
            "recorded_sweeps": int(self.buffers.n_rec),
        }

    @property
    def marginal_counts(self) -> np.ndarray:
        """(K, T) decoded marginal state counts (gathered from every
        process)."""
        K = self.spec.nr_states
        d = (
            self.mesh.all_gather(self.buffers.counts).cpu().numpy()
            .reshape(self.n_shards, K, self.T_local)
            .transpose(1, 0, 2)
            .reshape(K, self.n_shards * self.T_local)
        )
        return np.cumsum(d.astype(np.int64), axis=1)[:, : self.T].astype(np.int32)


def _choose_layout(T: int, n_shards: int) -> tuple[int, int]:
    """(T_local, cell_bits): shard size cell-aligned, cells <= 2^16."""
    t0 = -(-T // n_shards)  # ceil
    cell_bits = min(16, max(2, (max(t0, 4) - 1).bit_length()))
    cell = 1 << cell_bits
    T_local = -(-t0 // cell) * cell
    return T_local, cell_bits


def _local_r_with_edges(r_pad: np.ndarray, n_shards: int, T_local: int, cell: int):
    """Rearrange the global R ((T_pad, dim, 2), position-major) into the JAX
    package's per-shard layout: (n_shards * dim * 2, T_local + 1)
    position-axis-minor component rows, the extra column being R[shard_end]
    = the full sum of the cell starting at the shard's right edge (0 for the
    last shard)."""
    dim = r_pad.shape[1]
    out = np.zeros((n_shards * dim * 2, T_local + 1), dtype=np.float32)
    for j in range(n_shards):
        lo = j * T_local
        blk = np.zeros((T_local + 1, dim, 2), dtype=np.float32)
        blk[:T_local] = r_pad[lo : lo + T_local]
        edge = (j + 1) * T_local
        if edge < n_shards * T_local:
            blk[T_local] = r_pad[edge]
        out[j * dim * 2 : (j + 1) * dim * 2] = blk.transpose(1, 2, 0).reshape(
            dim * 2, T_local + 1
        )
    return out


def make_sharded_engine(
    data,
    mesh: PositionMesh | None = None,
    n_devices: int | None = None,
    T: int | None = None,
    dim: int | None = None,
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
    cap_local: int | None = None,
    device: str | torch.device | None = None,
) -> ShardedEngine:
    """Ingest + auto-priors + sharded engine construction.

    ``mesh`` None builds ``position_mesh(n_devices, device)`` (one shard
    when both are None). Ingest runs shard by shard with bounded host memory
    (O(T_local * dim) peak instead of O(T); parallel/ingest.py). ``data`` is
    either the (T, dim) array or a provider ``f(start, stop) -> chunk`` with
    explicit T/dim, so genome-scale inputs stream from disk without ever
    being resident."""
    if mesh is None:
        mesh = position_mesh(n_devices or 1, device)
    n_shards = mesh.n_shards
    if not callable(data):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data[:, None]
        T, dim = data.shape
    elif T is None or dim is None:
        raise ValueError("T and dim are required with a data provider")
    T_local, cell_bits = _choose_layout(T, n_shards)

    trace = runner._setup_tracer()
    ing = sharded_ingest(
        mesh, data, T, dim,
        T_local=T_local, cell_bits=cell_bits,
        weight_multiplier=weight_multiplier,
    )
    trace(f"ingest done (sharded, P={n_shards}, T_local={T_local})")

    spec = ModelSpec(nr_params, nr_data_dim, use_self_transitions)
    # auto-prior closed form from the streamed block means
    # (AutoPriors.hpp:86-107; same reduction as autoprior_host)
    S, S2, n = ing.block_means
    n = max(n, 1.0)
    mean = S / n
    var = S2 / n - mean * mean
    nig_row = nig_autoprior(s2, p, float(mean), float(var))
    trace("autoprior done")
    nig = np.tile(nig_row, (nr_params, 1))
    priors = HMMPriors.create(
        nig, spec.nr_states, trans, self_trans, initial_alpha, device=mesh.device
    )

    if cap_local is None:
        # clamp the initial sizing by the capacity ceiling too: the
        # prior-threshold boundary count is ~T
        cap_local = min(
            T_local, runner._MAX_CAPACITY, max(64, 4 * ing.nb0 // n_shards + 64)
        )

    eng = ShardedEngine(
        mesh=mesh,
        spec=spec,
        priors=priors,
        seed=seed,
        T=T,
        T_local=T_local,
        cell_bits=cell_bits,
        negw=ing.negw,
        rank=ing.rank,
        r_t=ing.r_t,
        q2_hi=ing.q2_hi,
        q2_lo=ing.q2_lo,
        records=records,
        cap_local=cap_local,
    )
    trace(f"engine init done (cap_local={eng.cap_local})")
    return eng
