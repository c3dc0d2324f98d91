"""The port's block extraction, ranking and block statistics against the JAX
package (hammlet_tpu/ops/blocks.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_bitwise, to_np
from hammlet_tpu.golden import reference as gold
from hammlet_tpu.ops import blocks as jb
from hammlet_tpu.runner import _ingest_prefix_program
from hammlet_tpu_torch import convert
from hammlet_tpu_torch.ops import blocks as tb

torch.set_num_threads(1)


def _weights(T, seed, dim=1, quantize=False):
    data = np.random.default_rng(seed).normal(0, 1, size=(T, dim)).astype(np.float32)
    data[T // 3 :] += 2.5  # one real change point
    w = gold.breakpoint_weights(gold.maxlet_transform(data))
    if quantize:  # many exact ties: exercises the stable tie order
        w = np.where(np.isfinite(w), np.round(w * 4) / 4, w).astype(np.float32)
    return data, w


@pytest.mark.parametrize("T", [100, 5000])
@pytest.mark.parametrize("quantize", [False, True])
def test_ranking_bitwise(T, quantize):
    """Tolerance: exact. Host and device stable rankings equal the JAX ones,
    ties included."""
    _, w = _weights(T, T, quantize=quantize)
    want = jb.build_ranked_weights_device(jnp.asarray(w))
    for got in (
        tb.build_ranked_weights(w),
        tb.build_ranked_weights_device(torch.from_numpy(w)),
    ):
        assert_bitwise(got.neg_w_sorted, want.neg_w_sorted)
        np.testing.assert_array_equal(to_np(got.pos_by_rank), to_np(want.pos_by_rank))


@pytest.mark.parametrize("capacity", [128, 384, 1000])
def test_bucketed_and_ranked_blocks_exact(capacity):
    """Tolerance: exact. bucket_candidates, and the block boundaries of
    make_blocks_bucketed and make_blocks_ranked at thresholds below, inside
    and above the bucket (the saturating overflow count included)."""
    T = 3000
    _, w = _weights(T, 11)
    jr = jb.build_ranked_weights(w)
    tr = tb.build_ranked_weights(w)
    jpos, jrank = jb.bucket_candidates(jr, capacity)
    tpos, trank = tb.bucket_candidates(tr, capacity)
    np.testing.assert_array_equal(to_np(tpos), to_np(jpos))
    np.testing.assert_array_equal(to_np(trank), to_np(jrank))
    for thr in [0.05, 0.5, 1.0, 2.0, 4.0, 50.0]:
        t32 = np.float32(thr)
        want = jb.make_blocks_bucketed(jpos, jrank, jr, jnp.float32(t32))
        got = tb.make_blocks_bucketed(tpos, trank, tr, torch.tensor(t32))
        assert int(got.n_blocks) == int(want.n_blocks)
        if int(want.n_blocks) <= capacity:
            for f in ("starts", "ends", "sizes"):
                np.testing.assert_array_equal(to_np(getattr(got, f)), to_np(getattr(want, f)))
        want_r = jb.make_blocks_ranked(jr, jnp.float32(t32), capacity)
        got_r = tb.make_blocks_ranked(tr, t32, capacity)
        assert int(got_r.n_blocks) == int(want_r.n_blocks)
        np.testing.assert_array_equal(to_np(got_r.starts), to_np(want_r.starts))
        np.testing.assert_array_equal(to_np(got_r.sizes), to_np(want_r.sizes))


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("cell_bits", [6, 16])
def test_host_prefix_and_block_stats_bitwise(dim, cell_bits):
    """Tolerance: bitwise. The host prefix build (float64 numpy in both
    packages), and block_sufficient_stats_t given the same PrefixStats, at
    block sets with padding."""
    T = 3000
    data, w = _weights(T, 5, dim=dim)
    jp = jb.build_prefix_stats(data, cell_bits)
    tp = tb.build_prefix_stats(data, cell_bits)
    for f in ("r_t", "q2_hi", "q2_lo"):
        assert_bitwise(getattr(tp, f), getattr(jp, f))
    jr = jb.build_ranked_weights(w)
    tr = tb.build_ranked_weights(w)
    tp = convert.prefix_stats(jp)
    for thr in [0.3, 1.5, 10.0]:
        want_blocks = jb.make_blocks_ranked(jr, jnp.float32(thr), 900)
        got_blocks = tb.make_blocks_ranked(tr, np.float32(thr), 900)
        assert_bitwise(
            tb.block_sufficient_stats_t(tp, got_blocks, cell_bits),
            jb.block_sufficient_stats_t(jp, want_blocks, cell_bits),
        )


@pytest.mark.parametrize("T,dim", [(20000, 1), (9000, 3)])
def test_device_prefix_within_tolerance(T, dim):
    """Tolerance: rtol 1e-5 relative to each cell's magnitude. The in-cell
    float32 cumsum runs in another order than XLA's; the cross-cell float64
    prefix is numpy in both (bitwise given equal cell totals, so compared at
    the same tolerance)."""
    data = np.random.default_rng(dim).normal(3, 2, size=(T, dim)).astype(np.float32)
    jr_t, jtot = _ingest_prefix_program(jnp.asarray(data), jb.DEVICE_CELL_BITS)
    got = tb.build_prefix_stats_device(torch.from_numpy(data), tb.DEVICE_CELL_BITS)
    want_r = np.asarray(jr_t)
    scale = np.abs(want_r).max(axis=2, keepdims=True)
    np.testing.assert_allclose(to_np(got.r_t), want_r, rtol=1e-5, atol=1e-5 * scale.max())
    want_full = jb.build_prefix_stats_device(jnp.asarray(data))
    np.testing.assert_allclose(
        to_np(got.q2_hi), np.asarray(want_full.q2_hi), rtol=1e-5
    )
    assert got.T == T and got.dim == dim
