"""Dynamic block compression: boundary extraction + O(1) block statistics.

Port of hammlet_tpu/ops/blocks.py. A block starts at every position t with
weight[t] >= threshold (w[0] = inf). Block sufficient statistics come from
two gathers into cell-structured prefix sums:

    sum[x, start:end) = R[start] - R[end] + Q2[end >> c] - Q2[start >> c]

where R is the in-cell reverse cumulative sum (float32) and Q2 the
inclusive cross-cell prefix held as a float32 (hi, lo) pair, accumulated in
float64 on the host. All per-sweep shapes are static: block arrays are
padded with T (empty blocks of size 0) up to a capacity.

Index tensors (positions, ranks, block starts) are int64, torch's index
type; the layouts match the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CELL_BITS = 16
CELL = 1 << CELL_BITS

#: cell size for the on-device prefix build: small enough that plain float32
#: in-cell cumsums stay well below the reference's Kahan-cell error
DEVICE_CELL_BITS = 12


class PrefixStats(NamedTuple):
    """Cell-structured prefix sums of per-position sufficient statistics.

    r_t:    (dim, 2, T+1) float32 — in-cell reverse cumsum of (x, x^2),
            position axis minor; r_t[..., T] = 0 handles end-of-data queries
    q2_hi:  (n_cells+1, dim, 2) float32 — inclusive cross-cell prefix (hi)
    q2_lo:  (n_cells+1, dim, 2) float32 — residual (lo) of the same
    """

    r_t: torch.Tensor
    q2_hi: torch.Tensor
    q2_lo: torch.Tensor

    @property
    def r(self) -> torch.Tensor:
        """(T+1, dim, 2) position-major view of ``r_t``."""
        return self.r_t.permute(2, 0, 1)

    @property
    def T(self) -> int:
        return self.r_t.shape[2] - 1

    @property
    def dim(self) -> int:
        return self.r_t.shape[0]


def _cross_cell_prefix(cell_tot: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive float64 prefix over the (n_cells, dim, 2) cell totals, with
    the final entry duplicated (so c(end) = n_cells works), split into a
    float32 (hi, lo) pair."""
    n_cells = cell_tot.shape[0]
    q2 = np.zeros((n_cells + 1,) + cell_tot.shape[1:], dtype=np.float64)
    np.cumsum(cell_tot, axis=0, out=q2[:n_cells])
    q2[n_cells] = q2[n_cells - 1]
    q2_hi = q2.astype(np.float32)
    q2_lo = (q2 - q2_hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(q2_hi).to(device), torch.from_numpy(q2_lo).to(device)


def build_prefix_stats(
    data: np.ndarray, cell_bits: int = CELL_BITS, device: torch.device | str = "cpu"
) -> PrefixStats:
    """Host-side ingest: PrefixStats from raw data (T,) or (T, dim).

    Accumulation runs in float64 and is rounded to float32 once."""
    cell = 1 << cell_bits
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    stats = np.stack([data, data * data], axis=-1)  # (T, dim, 2)
    n_cells = (T + cell - 1) // cell
    r = np.zeros((T + 1, dim, 2), dtype=np.float64)
    cell_tot = np.zeros((n_cells, dim, 2), dtype=np.float64)
    for c in range(n_cells):
        lo, hi = c * cell, min((c + 1) * cell, T)
        rc = np.cumsum(stats[lo:hi][::-1], axis=0)[::-1]  # reverse cumsum
        r[lo:hi] = rc
        cell_tot[c] = rc[0]
    q2_hi, q2_lo = _cross_cell_prefix(cell_tot, device)
    r_t = np.ascontiguousarray(r.astype(np.float32).transpose(1, 2, 0))
    return PrefixStats(torch.from_numpy(r_t).to(device), q2_hi, q2_lo)


def build_prefix_stats_device(
    data: torch.Tensor, cell_bits: int = DEVICE_CELL_BITS
) -> PrefixStats:
    """PrefixStats from device-resident (T, dim) float32 data.

    The in-cell reverse cumsums run in float32 over 2^cell_bits elements
    (small cells bound the error); the per-cell totals (T / 2^cell_bits
    values) round-trip through the host for an exact float64 cross-cell
    prefix."""
    cell = 1 << cell_bits
    T, dim = data.shape
    n_cells = -(-T // cell)
    stats = torch.stack([data, data * data], dim=-1)  # (T, dim, 2)
    stats = torch.nn.functional.pad(stats, (0, 0, 0, 0, 0, n_cells * cell - T))
    x = stats.reshape(n_cells, cell, dim, 2)
    r = torch.flip(torch.cumsum(torch.flip(x, dims=(1,)), dim=1), dims=(1,))
    totals = r[:, 0].to("cpu", torch.float64).numpy()  # (n_cells, dim, 2)
    r_t = torch.zeros((dim, 2, T + 1), dtype=torch.float32, device=data.device)
    r_t[:, :, :T] = r.reshape(n_cells * cell, dim, 2)[:T].permute(1, 2, 0)
    q2_hi, q2_lo = _cross_cell_prefix(totals, data.device)
    return PrefixStats(r_t, q2_hi, q2_lo)


class RankedWeights(NamedTuple):
    """Positions pre-sorted by breakpoint weight (descending), built once at
    ingest; per-sweep block extraction then costs O(capacity), not O(T).

    neg_w_sorted: (T,) float32 — ascending sort of -weights
    pos_by_rank:  (T,) int64   — position of the rank-r largest weight; ties
                  broken by position (stable sort)
    """

    neg_w_sorted: torch.Tensor
    pos_by_rank: torch.Tensor


def build_ranked_weights(
    weights: np.ndarray, device: torch.device | str = "cpu"
) -> RankedWeights:
    w = np.asarray(weights, dtype=np.float32)
    order = np.argsort(-w, kind="stable")
    return RankedWeights(
        neg_w_sorted=torch.from_numpy((-w[order]).astype(np.float32)).to(device),
        pos_by_rank=torch.from_numpy(order.astype(np.int64)).to(device),
    )


def build_ranked_weights_device(weights: torch.Tensor) -> RankedWeights:
    """RankedWeights from device-resident weights (device stable sort)."""
    neg_sorted, order = torch.sort(-weights, stable=True)
    return RankedWeights(neg_w_sorted=neg_sorted, pos_by_rank=order)


class BlockStructure(NamedTuple):
    """Fixed-capacity block decomposition of [0, T).

    starts: (Bcap,) int64 — block start positions, padded with T
    ends:   (Bcap,) int64 — block end positions (exclusive), padded with T
    sizes:  (Bcap,) int64 — block sizes, 0 for padding
    n_blocks: () int64    — number of real blocks (a device scalar)
    """

    starts: torch.Tensor
    ends: torch.Tensor
    sizes: torch.Tensor
    n_blocks: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]


def _ends(starts: torch.Tensor, T: int) -> torch.Tensor:
    return torch.cat([starts[1:], starts.new_full((1,), T)])


def make_blocks(weights: torch.Tensor, threshold: torch.Tensor, capacity: int) -> BlockStructure:
    """Threshold the breakpoint weights into a padded block structure: a
    block starts at every position with weight >= threshold (w[0] = inf),
    bit-identical to the reference's iterator for the same float32 threshold
    (BreakpointArray.hpp:224-231). O(T); the sweep uses
    make_blocks_bucketed."""
    T = weights.shape[0]
    mask = weights >= threshold
    n_blocks = torch.sum(mask)
    starts = torch.nonzero(mask)[:capacity, 0]
    starts = torch.cat([starts, starts.new_full((capacity - len(starts),), T)])
    ends = _ends(starts, T)
    return BlockStructure(starts, ends, ends - starts, n_blocks)


def blocks_from_sizes(sizes, capacity: int | None = None) -> BlockStructure:
    """Static block structure from an explicit size list (the reference's
    Blocks<Fixed>, src/Blocks/FixedBlocks.hpp:5-106; Splittable refinement is
    obtained by passing a refined size list), padded to ``capacity``."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if (sizes <= 0).any():
        raise ValueError("block sizes must be positive")
    T = int(sizes.sum())
    n = len(sizes)
    capacity = n if capacity is None else capacity
    if capacity < n:
        raise ValueError("capacity smaller than number of blocks")
    starts = np.full(capacity, T, dtype=np.int64)
    ends = np.full(capacity, T, dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(sizes)])
    starts[:n] = csum[:-1]
    ends[:n] = csum[1:]
    return BlockStructure(
        torch.from_numpy(starts), torch.from_numpy(ends),
        torch.from_numpy(ends - starts), torch.tensor(n),
    )


def split_block_sizes(sizes, index: int, s: int) -> list:
    """Split block ``index`` so its tail piece has size ``s`` — the
    reference's Blocks<Splittable>::split (src/Blocks/SplittableBlocks.hpp:
    53-67: sizes[i] -= s and a new block of size s after it). Raises if the
    block is not larger than ``s`` (the reference's guard)."""
    sizes = [int(v) for v in sizes]
    if sizes[index] <= s:
        raise ValueError("Cannot split block into this size!")
    return sizes[:index] + [sizes[index] - s, s] + sizes[index + 1 :]


def make_blocks_ranked(
    ranked: RankedWeights, threshold: torch.Tensor, capacity: int
) -> BlockStructure:
    """Block structure in O(capacity) work: boundary count by binary search
    on the sorted weights, boundary positions = sort of the top-count ranked
    positions (used by the auto-prior pass)."""
    T = ranked.pos_by_rank.shape[0]
    capacity = min(capacity, T)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=ranked.neg_w_sorted.device)
    n_blocks = torch.searchsorted(ranked.neg_w_sorted, (-thr).reshape(1), right=True)[0]
    rank = torch.arange(capacity, device=ranked.pos_by_rank.device)
    starts = torch.where(rank < n_blocks, ranked.pos_by_rank[:capacity], T)
    starts = torch.sort(starts).values
    ends = _ends(starts, T)
    return BlockStructure(starts, ends, ends - starts, n_blocks)


def block_sufficient_stats_t(
    prefix: PrefixStats, blocks: BlockStructure, cell_bits: int = CELL_BITS
) -> torch.Tensor:
    """(dim, 2, Bcap) float32 — block (sum x, sum x^2), block axis minor.

    Relies on ends[b] == starts[b+1] (ends[-1] == T, padded starts == T), so
    the end-point gathers are one-row shifts of the start-point gathers.
    Padded blocks yield exact zeros. The add order
    (r_s - r_e) + ((qh_e - qh_s) + (ql_e - ql_s)) is the JAX package's, so
    the result is bit-identical given the same PrefixStats."""
    s = blocks.starts
    cs = s >> cell_bits
    ce_last = prefix.T >> cell_bits  # cell index of the final end (= T)
    r_s = prefix.r_t[:, :, s]  # (dim, 2, B)
    r_e = torch.cat([r_s[:, :, 1:], torch.zeros_like(r_s[:, :, :1])], dim=2)
    # (2, dim, 2, n_cells+1) hi/lo stack
    q2c = torch.stack([prefix.q2_hi.permute(1, 2, 0), prefix.q2_lo.permute(1, 2, 0)])
    q_s = q2c[:, :, :, cs]  # (2, dim, 2, B)
    q_e = torch.cat([q_s[..., 1:], q2c[:, :, :, ce_last : ce_last + 1]], dim=3)
    qd = q_e - q_s
    return (r_s - r_e) + (qd[0] + qd[1])


def block_sufficient_stats(
    prefix: PrefixStats, blocks: BlockStructure, cell_bits: int = CELL_BITS
) -> torch.Tensor:
    """(Bcap, dim, 2) float32 — per-block (sum x, sum x^2) per dim."""
    return block_sufficient_stats_t(prefix, blocks, cell_bits).permute(2, 0, 1)


def bucket_candidates(
    ranked: RankedWeights, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Position-sorted boundary candidates for a capacity bucket (sorted
    once per capacity change, not per sweep).

    Returns (cand_pos, cand_rank): cand_pos ascending positions with a
    sentinel T appended; cand_rank[i] = weight rank of cand_pos[i]."""
    T = ranked.pos_by_rank.shape[0]
    top = ranked.pos_by_rank[:capacity]
    order = torch.argsort(top)  # positions are distinct: no ties
    cand_pos = torch.cat([top[order], top.new_full((1,), T)])
    return cand_pos, order


def make_blocks_bucketed(
    cand_pos: torch.Tensor,
    cand_rank: torch.Tensor,
    ranked: RankedWeights,
    threshold: torch.Tensor,
) -> BlockStructure:
    """Block structure from pre-sorted bucket candidates — no per-sweep sort.

    Identical to make_blocks_ranked whenever the boundary count fits the
    bucket (otherwise n_blocks > capacity flags the overflow). The count is
    a SATURATING masked count over the top capacity+1 ranked weights; the
    valid candidates are compacted with a cumsum and a scatter whose
    invalid entries all land in one trash slot past the end."""
    T = ranked.pos_by_rank.shape[0]
    capacity = cand_rank.shape[0]
    neg_head = ranked.neg_w_sorted[: min(capacity + 1, T)]
    n_blocks = torch.sum(neg_head <= -threshold)
    valid = cand_rank < n_blocks
    slot = torch.where(valid, torch.cumsum(valid, dim=0) - 1, capacity)
    sel = torch.full((capacity + 1,), capacity, dtype=torch.int64, device=cand_pos.device)
    sel.scatter_(0, slot, torch.arange(capacity, device=cand_pos.device))
    starts = cand_pos[sel[:capacity]]  # padded entries hit the T sentinel
    ends = _ends(starts, T)
    return BlockStructure(starts, ends, ends - starts, n_blocks)
