"""Host-side pieces of the position-sharded engine.

Port of hammlet_tpu/parallel/sharded.py. So far only the record-drain
reassembly (:710-771) is here; the single-device engine (runner.Engine) runs
it as the P = 1, T_local = T case.
"""

from __future__ import annotations

import numpy as np


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
