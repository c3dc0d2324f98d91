"""Forward-Backward Gibbs state-sequence sampling as two parallel scans.

Port of hammlet_tpu/samplers/forward_backward.py (the reference's
sequential sampler is src/StateSequence/ForwardBackward.hpp:16-213):

1. FORWARD. alpha_b = normalize(alpha_{b-1} @ (A * e_b)) is a product of
   per-block K x K matrices M_b = A * e_b[None, :]. A positive rescaling
   of any product cancels under the final normalization, so the inclusive
   prefix products are taken by an associative scan whose combine
   rescales by the max entry.
2. BACKWARD. For every block and successor state j an independent
   predecessor pred_b[j] is drawn by Gumbel-max; each pred_b is a random
   map [K] -> [K], and z_b = (pred_b ∘ ... ∘ pred_{last-1})(z_last). Map
   composition is associative, so a reverse scan composes the suffixes.

Both scans take the JAX package's two-level grouped form (Hillis-Steele
within groups of 128 blocks, a scan of the group totals, one broadcast
combine; flat Hillis-Steele at B <= 256 or B % 128 != 0). On a card they
run as the hand-written kernels of csrc/fbscan.cu (samplers/fb_cuda.py);
``prefix_matmul_scan_reference`` and ``suffix_compose_scan_reference`` are
their plain versions, which a CPU tensor takes.

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
from hammlet_tpu_torch.samplers import fb_cuda

_TINY_SCALE = 1e-35

#: group size of the two-level scans, the JAX package's _GROUP
#: (hammlet_tpu/samplers/forward_backward.py:71); csrc/fbscan.cu uses the same
_GROUP = 128


def _combine_t(earlier: torch.Tensor, later: torch.Tensor) -> torch.Tensor:
    """z[i,k] = sum_j earlier[i,j] later[j,k] over the leading (K, K) axes
    (the others broadcast), rescaled by its max entry. The sum runs over j
    in order, one multiply and one add per term, so that the CUDA kernels
    repeat it bit for bit (torch.sum would pick its own association)."""
    K = earlier.shape[0]
    z = earlier[:, 0, None] * later[None, 0]
    for j in range(1, K):
        z = z + earlier[:, j, None] * later[None, j]
    m = torch.amax(z, dim=(0, 1), keepdim=True)
    return z / torch.clamp(m, min=_TINY_SCALE)


def _hs_prefix_t(x: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele inclusive prefix products over the minor axis of a
    (K, K, ..., n) stack: log2(n) levels of shift (identity-padded on the
    left) and combine."""
    K, n = x.shape[0], x.shape[-1]
    eye = torch.eye(K, dtype=x.dtype, device=x.device).reshape((K, K) + (1,) * (x.dim() - 2))
    d = 1
    while d < n:
        shifted = torch.cat([eye.expand(tuple(x.shape[:-1]) + (d,)), x[..., :-d]], dim=-1)
        x = _combine_t(shifted, x)  # earlier @ later
        d <<= 1
    return x


def prefix_matmul_scan_reference(Mt: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the prefix-scan kernels (csrc/fbscan.cu) in
    the JAX package's grouped form (hammlet_tpu/samplers/forward_backward.py:
    94-130): Hillis-Steele within (K, K, *batch, G, 128) groups, a
    Hillis-Steele scan of the (K, K, *batch, G) group totals, then one
    broadcast combine with the exclusive group prefixes. Flat Hillis-Steele
    where the JAX package keeps it flat: B <= 256 or B not a multiple of
    128. Every batch row is scanned on its own."""
    B = Mt.shape[-1]
    if B <= 2 * _GROUP or B % _GROUP:
        return _hs_prefix_t(Mt)
    K, lead = Mt.shape[0], tuple(Mt.shape[:-1])
    x = _hs_prefix_t(Mt.reshape(lead + (B // _GROUP, _GROUP)))  # in-group prefixes
    pre = _hs_prefix_t(x[..., -1])  # inclusive prefixes of the group totals
    eye = torch.eye(K, dtype=Mt.dtype, device=Mt.device).reshape((K, K) + (1,) * (Mt.dim() - 2))
    pre = torch.cat([eye.expand(lead + (1,)), pre[..., :-1]], dim=-1)  # exclusive
    return _combine_t(pre[..., None], x).reshape(Mt.shape)


def _hs_suffix_t(x: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele suffix compositions over the minor axis of a (K, ...,
    n) stack of maps, identity-padded on the right."""
    K, n = x.shape[0], x.shape[-1]
    ident = torch.arange(K, dtype=x.dtype, device=x.device).reshape((K,) + (1,) * (x.dim() - 1))
    d = 1
    while d < n:
        later = torch.cat([x[..., d:], ident.expand(tuple(x.shape[:-1]) + (d,))], dim=-1)
        x = torch.gather(x, 0, later)  # combined[j,b] = x[later[j,b], b]
        d <<= 1
    return x


def suffix_compose_scan_reference(maps_t: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the suffix-scan kernels (csrc/fbscan.cu) in
    the JAX package's grouped form (hammlet_tpu/samplers/forward_backward.py:
    154-186): reverse Hillis-Steele within (K, *batch, G, 128) groups, a
    scan of the (K, *batch, G) whole-group compositions, then one broadcast
    composition; flat where the JAX package keeps it flat."""
    B = maps_t.shape[-1]
    if B <= 2 * _GROUP or B % _GROUP:
        return _hs_suffix_t(maps_t)
    K, lead = maps_t.shape[0], tuple(maps_t.shape[:-1])
    x = _hs_suffix_t(maps_t.reshape(lead + (B // _GROUP, _GROUP)))  # in-group suffixes
    after = _hs_suffix_t(x[..., 0])  # suffixes of the whole-group compositions
    ident = torch.arange(K, dtype=maps_t.dtype, device=maps_t.device).reshape(
        (K,) + (1,) * (maps_t.dim() - 1)
    )
    after = torch.cat([after[..., 1:], ident.expand(lead + (1,))], dim=-1)  # groups > q
    # out[j,q,r] = x[after[j,q], q, r]
    return torch.gather(x, 0, after[..., None].expand(x.shape)).reshape(maps_t.shape)


def prefix_matmul_scan_t(Mt: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products of B K x K matrices, block axis minor:
    (K, K, B) float32 -> (K, K, B), each product rescaled by its max entry;
    a (K, K, *batch, B) stack scans every batch row on its own (the sharded
    engine's local shards). A CUDA tensor goes through the Hopper kernels
    (fb_cuda.prefix_matmul_scan_cuda) or raises, a CPU tensor through their
    plain version."""
    if Mt.device.type == "cuda":
        return fb_cuda.prefix_matmul_scan_cuda(Mt)
    if Mt.device.type != "cpu":
        raise ValueError(f"unsupported device {Mt.device}")
    return prefix_matmul_scan_reference(Mt)


def suffix_compose_scan_t(maps_t: torch.Tensor) -> torch.Tensor:
    """Suffix compositions r_b = m_b ∘ m_{b+1} ∘ ... of index maps, (K, B)
    int64 (r_b[j] = m_b[r_{b+1}[j]]); identity-padded on the right. A
    (K, *batch, B) stack composes every batch row on its own. A CUDA tensor
    goes through the Hopper kernels (fb_cuda.suffix_compose_scan_cuda) or
    raises, a CPU tensor through their plain version."""
    if maps_t.device.type == "cuda":
        return fb_cuda.suffix_compose_scan_cuda(maps_t)
    if maps_t.device.type != "cpu":
        raise ValueError(f"unsupported device {maps_t.device}")
    return suffix_compose_scan_reference(maps_t)


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
