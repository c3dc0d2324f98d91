"""Forward-Backward Gibbs state-sequence sampling as two parallel scans.

Port of hammlet_tpu/samplers/forward_backward.py (the reference's
sequential sampler is src/StateSequence/ForwardBackward.hpp:16-213):

1. FORWARD. alpha_b = normalize(alpha_{b-1} @ (A * e_b)) is a product of
   per-block K x K matrices M_b = A * e_b[None, :]. A positive rescaling
   of any product cancels under the final normalization, so the inclusive
   prefix products are taken by a Hillis-Steele scan whose combine
   rescales by the max entry.
2. BACKWARD. For every block and successor state j an independent
   predecessor pred_b[j] is drawn by Gumbel-max; each pred_b is a random
   map [K] -> [K], and z_b = (pred_b ∘ ... ∘ pred_{last-1})(z_last). Map
   composition is associative, so a reverse Hillis-Steele scan composes
   the suffixes (one torch.gather per level).

Reference quirks reproduced for parity:
- the emission term includes (N-1) * log A_ss inside the forward recursion
  (ForwardBackward.hpp:77) AND the trellis column is retroactively scaled
  by exp((N-1) log A_ss) for every block except the last (:115-119);
- the last state is drawn from the *unscaled* final forward column
  (Trellis.hpp:61-66 via ForwardBackward.hpp:135).

Padding: blocks b >= n_blocks have identity forward matrices and identity
maps, so they pass through both scans without effect.
"""

from __future__ import annotations

import torch

from hammlet_tpu_torch.models.distributions import emission_log_weights_t, gumbel

_TINY_SCALE = 1e-35


def prefix_matmul_scan_t(Mt: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products of B K x K matrices, block axis minor:
    (K, K, B) -> (K, K, B), each product rescaled by its max entry; a
    (K, K, *batch, B) stack scans every batch row on its own (the sharded
    engine's local shards). Hillis-Steele: log2(B) levels of shift
    (identity-padded) + batched combine."""
    K, B = Mt.shape[0], Mt.shape[-1]
    batch = tuple(Mt.shape[2:-1])
    eye = torch.eye(K, dtype=Mt.dtype, device=Mt.device).reshape(
        (K, K) + (1,) * (Mt.dim() - 2)
    )
    x = Mt
    d = 1
    while d < B:
        shifted = torch.cat([eye.expand((K, K) + batch + (d,)), x[..., :-d]], dim=-1)
        # z[i,k,b] = sum_j shifted[i,j,b] * x[j,k,b]  (earlier @ later)
        z = torch.sum(shifted[:, :, None] * x[None], dim=1)
        m = torch.amax(z, dim=(0, 1), keepdim=True)
        x = z / torch.clamp(m, min=_TINY_SCALE)
        d <<= 1
    return x


def suffix_compose_scan_t(maps_t: torch.Tensor) -> torch.Tensor:
    """Suffix compositions r_b = m_b ∘ m_{b+1} ∘ ... of index maps, (K, B)
    int64 (r_b[j] = m_b[r_{b+1}[j]]); identity-padded on the right. A
    (K, *batch, B) stack composes every batch row on its own."""
    K, B = maps_t.shape[0], maps_t.shape[-1]
    ident = torch.arange(K, dtype=maps_t.dtype, device=maps_t.device).reshape(
        (K,) + (1,) * (maps_t.dim() - 1)
    )
    x = maps_t
    d = 1
    while d < B:
        # x[b+d], identity past the end
        later = torch.cat([x[..., d:], ident.expand(tuple(x.shape[:-1]) + (d,))], dim=-1)
        x = torch.gather(x, 0, later)  # combined[j,b] = x[later[j,b], b]
        d <<= 1
    return x


def forward_columns_t(
    log_e_t: torch.Tensor,
    sizes: torch.Tensor,
    n_blocks: torch.Tensor,
    A: torch.Tensor,
    pi: torch.Tensor,
    use_self_transitions: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward trellis columns, (K, B) layout. Returns (cols_t, last_col)."""
    K, B = log_e_t.shape
    dev = log_e_t.device
    sizes_f = sizes.to(torch.float32)
    valid = torch.arange(B, device=dev) < n_blocks

    log_a_ss = torch.log(torch.diagonal(A))  # (K,)
    E = log_e_t
    if use_self_transitions:
        E = E + (sizes_f[None, :] - 1.0) * log_a_ss[:, None]
    e = torch.exp(E - torch.amax(E, dim=0, keepdim=True))  # (K, B)
    M = A[:, :, None] * e[None, :, :]  # M[i,j,b] = A[i,j] e[j,b]
    eye = torch.eye(K, dtype=M.dtype, device=dev)[:, :, None]
    M = torch.where(valid[None, None, :], M, eye)
    P = prefix_matmul_scan_t(M)
    alpha = torch.sum(pi[:, None, None] * P, dim=0)  # (K, B)
    alpha = alpha / torch.clamp(
        torch.sum(alpha, dim=0, keepdim=True), min=_TINY_SCALE
    )
    last = torch.clamp(n_blocks - 1, min=0).reshape(1)
    last_col = torch.index_select(alpha, 1, last)[:, 0]  # (K,), no host sync
    if use_self_transitions:
        is_last = (torch.arange(B, device=dev) == n_blocks - 1)[None, :]
        scale = torch.exp((sizes_f[None, :] - 1.0) * log_a_ss[:, None])
        cols = torch.where(is_last, alpha, alpha * scale)
    else:
        cols = alpha
    return cols, last_col


def backward_sample_t(
    generator: torch.Generator | None,
    cols_t: torch.Tensor,
    last_col: torch.Tensor,
    n_blocks: torch.Tensor,
    A: torch.Tensor,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Backward sampling from (K, B) forward columns; returns (B,) int64.

    ``noise`` = (Gumbels (K,) for the last state, Gumbels (K, K, B) for the
    predecessor maps), pre-drawn."""
    K, B = cols_t.shape
    dev = cols_t.device
    if noise is None:
        g_last = gumbel(generator, (K,), dev)
        g_maps = gumbel(generator, (K, K, B), dev)
    else:
        g_last, g_maps = noise
    z_last = torch.argmax(torch.log(last_col) + g_last.reshape(K)).reshape(1)

    logits = (
        torch.log(torch.clamp(cols_t, min=1e-38))[:, None, :]
        + torch.log(torch.clamp(A, min=1e-38))[:, :, None]
    )  # (i, j, b)
    pred = torch.argmax(logits + g_maps, dim=0)  # (j, b)
    ident = torch.arange(K, device=dev)[:, None]
    use_pred = (torch.arange(B, device=dev) < n_blocks - 1)[None, :]
    maps = torch.where(use_pred, pred, ident)
    r = suffix_compose_scan_t(maps)  # (K, B)
    return torch.index_select(r, 0, z_last)[0]


def fb_sample_states(
    generator: torch.Generator | None,
    block_stats_t: torch.Tensor,  # (dim, 2, B) — ops.blocks.block_sufficient_stats_t
    sizes: torch.Tensor,
    n_blocks: torch.Tensor,
    theta_mean: torch.Tensor,
    theta_var: torch.Tensor,
    A: torch.Tensor,
    pi: torch.Tensor,
    mapping: torch.Tensor,
    use_self_transitions: bool = True,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Sample a per-block state path with the FB-Gibbs kernel. (B,) int64.
    ``noise``: pre-drawn Gumbels (backward_sample_t)."""
    log_e_t = emission_log_weights_t(
        block_stats_t, sizes, theta_mean, theta_var, mapping
    )
    cols_t, last_col = forward_columns_t(
        log_e_t, sizes, n_blocks, A, pi, use_self_transitions
    )
    return backward_sample_t(generator, cols_t, last_col, n_blocks, A, noise)
