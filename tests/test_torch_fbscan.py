"""The port's grouped FB scans (samplers/forward_backward.py: the plain
versions of the csrc/fbscan.cu kernels) against the JAX package's
(hammlet_tpu/samplers/forward_backward.py:94-186), and the dispatch in
front of the kernels (samplers/fb_cuda.py). The kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py [fbscan])."""

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import sweep_like_matrices, to_np, to_torch, toy_problem
from hammlet_tpu.models import distributions as jd
from hammlet_tpu.samplers import forward_backward as jfb
from hammlet_tpu_torch import _build
from hammlet_tpu_torch.samplers import fb_cuda
from hammlet_tpu_torch.samplers import forward_backward as tfb

torch.set_num_threads(1)

SIZES = [8, 130, 256, 384, 1024, 29_696]
KS = [1, 2, 3, 5]
# the team instances of csrc/fbscan.cu (K = 9-16), the wide ones (K = 17-32, a thread block
# cluster per group; -s C 3 3 is K = 27) and the tiled products (K = 33-64; -s C 6 2 is 36,
# -s C 4 3 is 64): flat (130) and grouped (3 and 8 groups)
TEAM_SIZES = [130, 384, 1024]
TEAM_KS = [9, 10, 16, 17, 21, 27, 32, 33, 36, 64]
# above K = 64, the tiled products with j streamed (one tile a side up to K = 128, two above;
# -s C 3 4 is K = 81): flat (130) and grouped (3 groups); the plain versions' K^3 products on one
# CPU thread bound the shapes (K = 129 at 384: ~22 s)
OVER64_SIZES = [130, 384]
OVER64_KS = [81, 129]
# K > 512 (-s C 5 4's 625; 513, the first K whose transposes take a row in pieces on a card) at
# a few blocks: one combine of the plain versions takes ~0.5 s at K = 625 on one thread
OVER512_SIZES = [2, 4]
OVER512_KS = [513, 625]


def _matrices(shape, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, size=shape).astype(np.float32)


def _maps(K, shape, seed):
    return np.random.default_rng(seed).integers(0, K, size=(K,) + shape).astype(np.int32)


def _padded(K, S, B, seed):
    """(K, K, S, B) matrices and (K, S, B) maps with the sweep's padding:
    the second half of row 1 and all of the last row are identities."""
    M = _matrices((K, K, S, B), seed)
    maps = _maps(K, (S, B), seed + 1)
    M[:, :, 1, B // 2:] = np.eye(K, dtype=np.float32)[:, :, None]
    M[:, :, -1] = np.eye(K, dtype=np.float32)[:, :, None]
    maps[:, 1, B // 2:] = np.arange(K)[:, None]
    maps[:, -1] = np.arange(K)[:, None]
    return M, maps


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("K", KS)
def test_prefix_scan_matches_jax(B, K):
    """Tolerance: rtol 1e-5, atol 1e-30 (the grouping is the JAX package's,
    flat at B <= 256 or B % 128 != 0, grouped above; the per-level sums may
    be associated differently). Measured: bitwise equal to the JAX function
    on the CPU at every B and K here."""
    M = _matrices((K, K, B), B * 10 + K)
    np.testing.assert_allclose(
        to_np(tfb.prefix_matmul_scan_t(to_torch(M))),
        np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M))), rtol=1e-5, atol=1e-30,
    )


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("K", KS)
def test_suffix_scan_matches_jax(B, K):
    """Tolerance: exact (integer composition; int64 maps here, int32 in
    JAX)."""
    maps = _maps(K, (B,), B * 10 + K)
    got = tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(to_np(got), np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps))))


@pytest.mark.parametrize("B", TEAM_SIZES)
@pytest.mark.parametrize("K", TEAM_KS)
def test_prefix_scan_matches_jax_at_team_k(B, K):
    """The K = 9-64 shapes (configuration 4's K = 9, -s C 3 3's 27, -s C 4
    3's 64, the -s up to 64). Tolerance as test_prefix_scan_matches_jax:
    rtol 1e-5, atol 1e-30."""
    M = _matrices((K, K, B), B * 10 + K)
    np.testing.assert_allclose(
        to_np(tfb.prefix_matmul_scan_t(to_torch(M))),
        np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M))), rtol=1e-5, atol=1e-30,
    )


@pytest.mark.parametrize("B", TEAM_SIZES)
@pytest.mark.parametrize("K", TEAM_KS)
def test_suffix_scan_matches_jax_at_team_k(B, K):
    """The K = 9-64 shapes. Tolerance: exact."""
    maps = _maps(K, (B,), B * 10 + K)
    np.testing.assert_array_equal(
        to_np(tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))),
        np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps))),
    )


@pytest.mark.parametrize("B", OVER64_SIZES)
@pytest.mark.parametrize("K", OVER64_KS)
def test_prefix_scan_matches_jax_above_k64(B, K):
    """The K > 64 shapes (-s C 3 4's 81; 129, the first K of two tiles a
    side on a card). Tolerance as test_prefix_scan_matches_jax: rtol 1e-5,
    atol 1e-30."""
    M = _matrices((K, K, B), B * 10 + K)
    np.testing.assert_allclose(
        to_np(tfb.prefix_matmul_scan_t(to_torch(M))),
        np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M))), rtol=1e-5, atol=1e-30,
    )


@pytest.mark.parametrize("B", OVER64_SIZES)
@pytest.mark.parametrize("K", OVER64_KS)
def test_suffix_scan_matches_jax_above_k64(B, K):
    """The K > 64 shapes (on a card the grouped form's group kernel keeps
    the maps in shared memory). Tolerance: exact."""
    maps = _maps(K, (B,), B * 10 + K)
    np.testing.assert_array_equal(
        to_np(tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))),
        np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps))),
    )


@pytest.mark.parametrize("B", OVER512_SIZES)
@pytest.mark.parametrize("K", OVER512_KS)
def test_prefix_scan_matches_jax_above_k512(B, K):
    """The K > 512 shapes, flat (on a card the tiled kernel's transposes
    take each row of 32 matrices in pieces there). Tolerance as
    test_prefix_scan_matches_jax: rtol 1e-5, atol 1e-30."""
    M = _matrices((K, K, B), B * 10 + K)
    np.testing.assert_allclose(
        to_np(tfb.prefix_matmul_scan_t(to_torch(M))),
        np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M))), rtol=1e-5, atol=1e-30,
    )


@pytest.mark.parametrize("B", OVER512_SIZES)
@pytest.mark.parametrize("K", OVER512_KS)
def test_suffix_scan_matches_jax_above_k512(B, K):
    """The K > 512 shapes (on a card the rows scan). Tolerance: exact."""
    maps = _maps(K, (B,), B * 10 + K)
    np.testing.assert_array_equal(
        to_np(tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))),
        np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps))),
    )


@pytest.mark.parametrize("K", [9, 16, 27])
def test_four_rows_match_per_row_jax_at_team_k(K):
    """Four rows in one call (the sweep's padding: the second half of row 1
    and all of the last row identities) at B = 1024, each row against the
    JAX function on that row. Tolerance: prefix rtol 1e-5, atol 1e-30;
    suffix exact."""
    M, maps = _padded(K, 4, 1024, 70 + K)
    got = tfb.prefix_matmul_scan_t(to_torch(M))
    sgot = tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))
    for r in range(4):
        np.testing.assert_allclose(
            to_np(got[:, :, r]), np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M[:, :, r]))),
            rtol=1e-5, atol=1e-30)
        np.testing.assert_array_equal(
            to_np(sgot[:, r]), np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps[:, r]))))


def _division_cases(case):
    """(z, m) float32 pairs: random rows z in [0, m] with m the row max
    (clamped at 1e-35 as the combine clamps it), every subnormal magnitude
    class, quotients that fall exactly on a float32 midpoint in the
    subnormal range, or NaN and inf."""
    rng = np.random.default_rng(11)
    tiny = 2.0 ** -149
    if case == "rows":
        z = (rng.uniform(0, 1, (50_000, 9)) * 2.0 ** rng.integers(-170, 8, (50_000, 9)))
        z = z.astype(np.float32)
        m = np.maximum(z.max(axis=1, keepdims=True), np.float32(1e-35))
        return z.ravel(), np.broadcast_to(m, z.shape).ravel()
    if case == "subnormal_classes":
        # every binade of the subnormals (2^e .. 2^(e+1) - 1 ulps, e = 0..22) over many m
        e = np.repeat(np.arange(23), 4000)
        z = ((2.0 ** e + rng.integers(0, 2 ** 22, e.size) % 2.0 ** e) * tiny).astype(np.float32)
        m = rng.uniform(1, 2, e.size) * 2.0 ** rng.integers(-117, 4, e.size)
        m = np.where(rng.random(e.size) < 0.5, m, rng.integers(1, 200, e.size)).astype(np.float32)
        return z, m
    if case == "midpoints":
        # z = (2j + 1) k ulps, m = 2k: the quotient is (j + 1/2) ulps, a tie
        k, j = np.meshgrid(np.arange(1, 3000), np.arange(0, 200))
        num = ((2 * j + 1) * k).ravel()
        keep = num < 2 ** 24
        z = (num[keep] * tiny).astype(np.float32)
        assert np.array_equal(z.astype(np.float64), num[keep] * tiny)  # exact
        return z, (2 * k.ravel()[keep]).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, tiny, 3e38], np.float32)
    return tuple(a.ravel() for a in np.meshgrid(special, special))


def _assert_same_bits(got, want, z, m):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    bad = np.flatnonzero(got[keep].view(np.int32) != want[keep].view(np.int32))
    assert bad.size == 0, (z[keep][bad[:5]], m[keep][bad[:5]])


def _float32_quotient(z, m):
    with np.errstate(divide="ignore", invalid="ignore", over="ignore", under="ignore"):
        return z / m


@pytest.mark.parametrize("case", ["rows", "subnormal_classes", "midpoints", "nan_inf"])
def test_float64_quotient_is_the_float32_quotient(case):
    """Exact: the float64 quotient rounded to float32,
    np.float32(np.float64(z) / np.float64(m)), has the bits of the float32
    division __fdiv_rn (and torch's ``/``) gives, subnormal results
    included; numpy rounds as IEEE does. The midpoints also show why the
    kernels do not take z * (1 / m) alone: at 147 ulps / 98 it rounds the
    other way."""
    z, m = _division_cases(case)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        got = (z.astype(np.float64) / m.astype(np.float64)).astype(np.float32)
    _assert_same_bits(got, _float32_quotient(z, m), z, m)
    if case == "midpoints":
        tiny = np.float64(2.0 ** -149)
        short = np.float32(147 * tiny * (1.0 / np.float64(98.0)))
        assert short.view(np.int32) != (np.float32(147 * tiny) / np.float32(98)).view(np.int32)


def _kernel_quotient(z: float, m: float) -> float:
    """csrc/fbscan.cu's wide_quotient in exact arithmetic: y = RN(1 / m),
    t = RN(z y), r = RN(z - m t), q = RN32(RN(t + r y)), each FMA rounded
    once (Fractions, then one rounding to float64); a zero z stays z, and an
    inf or NaN operand takes the float32 division, as rescale does."""
    if not (np.isfinite(z) and np.isfinite(m)):
        return _float32_quotient(np.float32(z), np.float32(m))
    if z == 0:
        return np.float32(z)
    y = float(Fraction(1) / Fraction(m))
    t = z * y
    r = float(Fraction(z) - Fraction(m) * Fraction(t))
    return np.float32(float(Fraction(r) * Fraction(y) + Fraction(t)))


@pytest.mark.parametrize("case", ["rows", "subnormal_classes", "midpoints", "nan_inf"])
def test_kernel_division_is_the_float32_quotient(case):
    """Exact: the kernels' division (one reciprocal per combine and
    Markstein's correction in float64, then rounded to float32) gives the
    bits of the float32 division on the same pairs, every 16th of them,
    with m clamped at 1e-35 as the combine clamps it (NaN stays NaN)."""
    z, m = (a[::16] if a.size > 1000 else a for a in _division_cases(case))
    with np.errstate(invalid="ignore"):
        m = np.where(m < np.float32(1e-35), np.float32(1e-35), m)
    got = [_kernel_quotient(float(a), float(b)) for a, b in zip(z, m)]
    _assert_same_bits(got, _float32_quotient(z, m), z, m)


@pytest.mark.parametrize("B", [384, 29_696])
@pytest.mark.parametrize("K", [3, 5])
def test_prefix_scan_on_sweep_like_matrices_matches_jax(B, K):
    """The prefix scan on matrices shaped like the sweep's (about half
    zeros, ~1 % subnormal entries, from exp(E - max E) with E down to -110)
    against the JAX function. Tolerance: rtol 1e-5, atol 1e-30, as above
    (XLA on the CPU flushes subnormals, torch keeps them; they sit far
    below atol)."""
    M = sweep_like_matrices(K, 1, B, B + K)[:, :, 0]
    assert (M == 0).mean() > 0.4 and ((M > 0) & (M < np.finfo(np.float32).tiny)).any()
    np.testing.assert_allclose(
        to_np(tfb.prefix_matmul_scan_t(to_torch(M))),
        np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M))), rtol=1e-5, atol=1e-30,
    )


@pytest.mark.parametrize("B", [130, 384, 1024])
@pytest.mark.parametrize("K", [1, 3])
def test_batched_scans_match_per_row_jax(B, K):
    """A (K, K, S, B) / (K, S, B) stack (the sharded engine's local shards,
    padded as the sweep pads them) against a loop of the JAX function over
    the rows. Tolerance: prefix rtol 1e-5, atol 1e-30; suffix exact."""
    S = 4
    M, maps = _padded(K, S, B, B + K)
    got = to_np(tfb.prefix_matmul_scan_t(to_torch(M)))
    sgot = to_np(tfb.suffix_compose_scan_t(to_torch(maps, torch.int64)))
    for s in range(S):
        np.testing.assert_allclose(
            got[:, :, s], np.asarray(jfb.prefix_matmul_scan_t(jnp.asarray(M[:, :, s]))),
            rtol=1e-5, atol=1e-30,
        )
        np.testing.assert_array_equal(
            sgot[:, s], np.asarray(jfb.suffix_compose_scan_t(jnp.asarray(maps[:, s])))
        )
    # a row of identities scans to identities
    np.testing.assert_array_equal(got[:, :, -1], np.broadcast_to(np.eye(K)[:, :, None], (K, K, B)))
    np.testing.assert_array_equal(sgot[:, -1], np.broadcast_to(np.arange(K)[:, None], (K, B)))


@pytest.mark.parametrize("B", [8, 384, 29_696])
def test_rows_scan_independently_bitwise(B):
    """Exact: four rows in one call equal four one-row calls, bit for bit
    (the per-shard bytes do not depend on how many shards a call holds)."""
    K, S = 3, 4
    M, maps = _padded(K, S, B, 5 * B)
    M_t, maps_t = to_torch(M), to_torch(maps, torch.int64)
    got = tfb.prefix_matmul_scan_t(M_t)
    sgot = tfb.suffix_compose_scan_t(maps_t)
    for s in range(S):
        one = tfb.prefix_matmul_scan_t(M_t[:, :, s : s + 1].contiguous())[:, :, 0]
        assert torch.equal(got[:, :, s].view(torch.int32), one.view(torch.int32)), s
        assert torch.equal(sgot[:, s], tfb.suffix_compose_scan_t(maps_t[:, s : s + 1])[:, 0]), s


def _log_e(p):
    return jd.emission_log_weights_t(
        jnp.asarray(p["stats_t"]), jnp.asarray(p["sizes"]),
        jnp.asarray(p["theta_mean"]), jnp.asarray(p["theta_var"]),
        jnp.asarray(p["mapping"]),
    )


@pytest.mark.parametrize("use_self", [True, False])
def test_forward_columns_grouped_within_rtol(use_self):
    """forward_columns_t at B = 2048 (the grouped scans in both packages).
    Tolerance: rtol 1e-5, atol 1e-30, as test_torch_samplers.py's."""
    B, pad = 2000, 48
    p = toy_problem(B=B, seed=21, pad=pad)
    log_e = _log_e(p)
    want_cols, want_last = jfb.forward_columns_t(
        log_e, jnp.asarray(p["sizes"]), jnp.int32(B),
        jnp.asarray(p["A"]), jnp.asarray(p["pi"]), use_self,
    )
    got_cols, got_last = tfb.forward_columns_t(
        to_torch(log_e), to_torch(p["sizes"]), torch.tensor(B),
        to_torch(p["A"]), to_torch(p["pi"]), use_self,
    )
    np.testing.assert_allclose(to_np(got_cols)[:, :B], np.asarray(want_cols)[:, :B], rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(to_np(got_last), np.asarray(want_last), rtol=1e-5, atol=1e-30)


def _jax_noise(key, K, B):
    """The Gumbels JAX's backward_sample_t draws from ``key``
    (forward_backward.py:237-245)."""
    k_last, k_maps = jax.random.split(key)
    return (
        to_torch(jax.random.gumbel(k_last, (1, K), dtype=jnp.float32)),
        to_torch(jax.random.gumbel(k_maps, (K, K, B), dtype=jnp.float32)),
    )


@pytest.mark.parametrize("n_blocks", [1500, 2048])
def test_backward_sample_grouped_exact_given_jax_noise(n_blocks):
    """Exact: fed the JAX forward columns and the JAX draws at B = 2048 (the
    grouped suffix scan), the port samples the same path."""
    B = 2048
    p = toy_problem(B=n_blocks, seed=8, pad=B - n_blocks)
    cols, last = jfb.forward_columns_t(
        _log_e(p), jnp.asarray(p["sizes"]), jnp.int32(n_blocks),
        jnp.asarray(p["A"]), jnp.asarray(p["pi"]), True,
    )
    key = jax.random.PRNGKey(31)
    want = jfb.backward_sample_t(key, cols, last, jnp.int32(n_blocks), jnp.asarray(p["A"]))
    got = tfb.backward_sample_t(
        None, to_torch(cols), to_torch(last), torch.tensor(n_blocks),
        to_torch(p["A"]), noise=_jax_noise(key, 3, B),
    )
    np.testing.assert_array_equal(to_np(got)[:n_blocks], np.asarray(want)[:n_blocks])


def test_fb_sample_states_grouped_matches_jax_given_noise():
    """fb_sample_states end to end at B = 2048 against the JAX function with
    its own draws handed to the port. Tolerance: exact (the forward columns
    agree within rtol 1e-5 above; here they select the same path)."""
    B, n_blocks = 2048, 1900
    p = toy_problem(B=n_blocks, seed=12, pad=B - n_blocks)
    key = jax.random.PRNGKey(4)
    want = jfb.fb_sample_states(
        key, jnp.asarray(p["stats_t"]), jnp.asarray(p["sizes"]), jnp.int32(n_blocks),
        jnp.asarray(p["theta_mean"]), jnp.asarray(p["theta_var"]), jnp.asarray(p["A"]),
        jnp.asarray(p["pi"]), jnp.asarray(p["mapping"]), True,
    )
    got = tfb.fb_sample_states(
        None, to_torch(p["stats_t"]), to_torch(p["sizes"]), torch.tensor(n_blocks),
        to_torch(p["theta_mean"]), to_torch(p["theta_var"]), to_torch(p["A"]),
        to_torch(p["pi"]), to_torch(p["mapping"], torch.int64), True,
        noise=_jax_noise(key, 3, B),
    )
    np.testing.assert_array_equal(to_np(got)[:n_blocks], np.asarray(want)[:n_blocks])


class _CardTensor:
    """Stands in for a CUDA tensor on a machine without one: what the
    dispatch and the wrappers read before they reach the kernel library."""

    device = torch.device("cuda", 0)
    is_cuda = True

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def contiguous(self):
        return self


def test_cpu_tensor_never_reaches_the_library(monkeypatch):
    """A CPU tensor takes the plain versions: the library is never loaded
    and no wrapper counts a launch."""
    def no_library():
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(fb_cuda, "_library", no_library)
    counters = (fb_cuda.prefix_matmul_scan_cuda, fb_cuda.suffix_compose_scan_cuda)
    before = [f.launches for f in counters]
    M, maps = _padded(3, 2, 384, 9)
    tfb.prefix_matmul_scan_t(to_torch(M))
    tfb.suffix_compose_scan_t(to_torch(maps, torch.int64))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("kind", ["prefix", "suffix"])
def test_cuda_tensor_without_library_raises(kind, monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernels or raises: with no nvcc to build
    the library the call raises, and the plain version is never run."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fb_cuda, "_lib", None)

    def fell_back(*_):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(tfb, "prefix_matmul_scan_reference", fell_back)
    monkeypatch.setattr(tfb, "suffix_compose_scan_reference", fell_back)
    if kind == "prefix":
        x, scan = _CardTensor((3, 3, 384), torch.float32), tfb.prefix_matmul_scan_t
    else:
        x, scan = _CardTensor((3, 384), torch.int64), tfb.suffix_compose_scan_t
    with pytest.raises(RuntimeError, match="nvcc not found"):
        scan(x)


def test_scans_refuse_other_devices_and_types():
    """Any device but the card and the CPU raises; the wrappers refuse host
    tensors and the wrong dtype or shape."""
    with pytest.raises(ValueError, match="unsupported device"):
        tfb.prefix_matmul_scan_t(torch.zeros((3, 3, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tfb.suffix_compose_scan_t(torch.zeros((3, 8), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb_cuda.prefix_matmul_scan_cuda(torch.zeros((3, 3, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb_cuda.suffix_compose_scan_cuda(torch.zeros((3, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        fb_cuda.prefix_matmul_scan_cuda(_CardTensor((3, 3, 8), torch.float64))
    with pytest.raises(ValueError, match="int64"):
        fb_cuda.suffix_compose_scan_cuda(_CardTensor((3, 8), torch.int32))
