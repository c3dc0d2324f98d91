"""Haar maxlet transform and breakpoint weights as plain level-wise torch.

Port of hammlet_tpu/ops/wavelet.py. Both functions perform the reference's
tree of pairwise float32 adds and exact max/compares (src/wavelet.hpp:98-188
and :68-93), so they are bit-identical to the golden model on any device.
This module is also the plain version that the Hopper maxlet transform
(ops/wavelet_cuda.py) is held against.

Semantics:
- ``maxlet_transform(data)``: coeffs[t] = max over dims of
  (1/sqrt(2))^level * |sum_L - sum_R| for the unique Haar wavelet whose
  central discontinuity is at t (level = ctz(t)+1). Positions whose wavelet
  support is not fully contained in [0, T), and position 0, are +inf.
- ``breakpoint_weights(coeffs)``: w[t] = max |coeff| over all wavelets with
  any discontinuity (center or support edge) at t, via top-down dyadic
  max-propagation; trailing positions whose sibling lies beyond T are +inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SQRT2HALF = np.float32(np.float32(np.sqrt(np.float64(2.0))) / np.float32(2.0))


def _level_normalizers(n_levels: int) -> list[np.float32]:
    """(1/sqrt2)^level computed by repeated float32 multiplication, matching
    the reference's running `normalizer *= sqrt2half` (wavelet.hpp:172)."""
    norms = []
    norm = _SQRT2HALF
    for _ in range(n_levels):
        norms.append(norm)
        norm = np.float32(norm * _SQRT2HALF)
    return norms


def maxlet_transform(data: torch.Tensor) -> torch.Tensor:
    """data: (T,) or (T, dim) float32 -> coeffs (T,) float32."""
    if data.ndim == 1:
        data = data[:, None]
    T = data.shape[0]
    coeffs = torch.full((T,), math.inf, dtype=torch.float32, device=data.device)
    n_levels = max(1, T.bit_length() - 1) if T > 0 else 0
    norms = _level_normalizers(n_levels + 1)
    sums = data.to(torch.float32)
    level = 1
    while sums.shape[0] >= 2:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        # the float32 normalizer times a float32 |difference| rounds once,
        # exactly as a float32 multiply; amax propagates NaN like jnp.max
        detail = torch.amax(float(norms[level - 1]) * torch.abs(left - right), dim=1)
        # node a covers [a*2^l, (a+1)*2^l); after tail-dropping every kept
        # node is complete, and its coefficient index a*2^l + 2^(l-1) < T
        coeffs[(1 << (level - 1)) :: (1 << level)][:n_pairs] = detail
        sums = left + right  # pairwise-dyadic float32 adds (exact ref order)
        level += 1
    if T > 0:
        coeffs[0] = math.inf
    return coeffs


def breakpoint_weights(coeffs: torch.Tensor) -> torch.Tensor:
    """coeffs: (T,) float32 maxlet transform -> breakpoint weights (T,).

    Top-down propagation as a pyramid: level I only touches multiples of I,
    and the centers it reads (odd multiples of I) are raw coefficients, so
    the carry is the current values at multiples of 2I, interleaved with the
    raw centers after each level. All ops are exact max/compares, so the
    result is bit-identical to the reference's in-place loop."""
    T = coeffs.shape[0]
    dev = coeffs.device
    p = 1
    while p < T:
        p *= 2
    cpad = torch.nn.functional.pad(coeffs, (0, p - T))  # pads are never selected
    A = cpad[:1]  # values at multiples of p (position 0)
    interval = p // 2
    neg_inf = torch.tensor(-math.inf, dtype=coeffs.dtype, device=dev)
    pos_inf = torch.tensor(math.inf, dtype=coeffs.dtype, device=dev)
    while interval >= 1:
        m = cpad[interval :: 2 * interval]  # raw centers: odd multiples of I
        nm = m.shape[0]
        center = (2 * torch.arange(nm, device=dev) + 1) * interval
        # a node exists iff its center is a data position; it propagates
        # only if its right edge (2k+2)*I also lies inside [0, T), else the
        # node and its left edge become inf (wavelet support incomplete)
        active = center < T
        cond = active & (center + interval < T)
        left = torch.where(cond, m, neg_inf)
        force_inf = torch.where(active & ~cond, pos_inf, neg_inf)
        new_a = torch.maximum(A, torch.maximum(left, force_inf))
        # right edge of node k is edge k+1
        new_a = torch.maximum(new_a, torch.cat([neg_inf[None], left[: nm - 1]]))
        new_m = torch.where(cond | ~active, m, pos_inf)
        A = torch.stack([new_a, new_m], dim=1).reshape(2 * nm)
        interval //= 2
    return A[:T]
