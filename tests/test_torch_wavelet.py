"""The port's maxlet transform, breakpoint weights and Hopper maxlet kernel
wrapper against the JAX package and the golden model: bitwise."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import assert_bitwise, to_np
from hammlet_tpu.golden import reference as gold
from hammlet_tpu.ops import wavelet as jwav
from hammlet_tpu.ops.wavelet_pallas import maxlet_transform_pallas
from hammlet_tpu_torch import _build
from hammlet_tpu_torch.ops import wavelet, wavelet_cuda

torch.set_num_threads(1)


def _data(T, dim, seed):
    return np.random.default_rng(seed).normal(1, 2, size=(T, dim)).astype(np.float32)


@pytest.mark.parametrize("T", [100, 8193, 20000])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_maxlet_bitwise_vs_jax_pallas_and_golden(T, dim):
    """Tolerance: bitwise. The plain port and the kernel wrapper (on a CPU
    tensor: the plain versions of the chunk and cross-chunk kernels in
    turn) equal the JAX level-wise transform, the Pallas kernel in
    interpret mode and the golden model."""
    data = _data(T, dim, T * 10 + dim)
    want = gold.maxlet_transform(data)
    assert_bitwise(jwav.maxlet_transform(jnp.asarray(data)), want)
    assert_bitwise(maxlet_transform_pallas(jnp.asarray(data), interpret=True), want)
    x = torch.from_numpy(data)
    assert_bitwise(wavelet.maxlet_transform(x), want)
    counters = (wavelet_cuda.maxlet_transform_cuda, wavelet_cuda.maxlet_chunks_cuda,
                wavelet_cuda.maxlet_cross_cuda)
    before = [f.launches for f in counters]
    assert_bitwise(wavelet_cuda.maxlet_transform_cuda(x), want)
    assert [f.launches for f in counters] == before  # CPU: no kernel


@pytest.mark.parametrize("T", [1, 2, 3, 5, 16, 17, 255, 1000])
def test_maxlet_small_sizes_bitwise(T):
    """Tolerance: bitwise, at sizes below one chunk and level edge cases."""
    data = _data(T, 1, T)
    want = gold.maxlet_transform(data)
    assert_bitwise(wavelet.maxlet_transform(torch.from_numpy(data)), want)
    assert_bitwise(wavelet_cuda.maxlet_transform_cuda(torch.from_numpy(data[:, 0])), want)


@pytest.mark.parametrize("T", [2, 3, 100, 8193, 20000])
def test_breakpoint_weights_bitwise(T):
    """Tolerance: bitwise (exact max/compares) vs JAX and golden."""
    coeffs = gold.maxlet_transform(_data(T, 1, T + 999))
    want = gold.breakpoint_weights(coeffs)
    assert_bitwise(jwav.breakpoint_weights(jnp.asarray(coeffs)), want)
    assert_bitwise(wavelet.breakpoint_weights(torch.from_numpy(coeffs)), want)


def test_maxlet_nan_propagates_like_jax():
    """A NaN in any dim makes every coefficient whose support holds it NaN,
    as jnp.max does (torch.amax propagates NaN; the CUDA kernel's max does
    too). Tolerance: same NaN positions, bitwise elsewhere."""
    data = _data(20000, 3, 4)
    data[[17, 4096, 8191, 12345], [0, 2, 1, 2]] = np.nan
    want = np.asarray(jwav.maxlet_transform(jnp.asarray(data)))
    for got in (
        wavelet.maxlet_transform(torch.from_numpy(data)),
        wavelet_cuda.maxlet_transform_cuda(torch.from_numpy(data)),
    ):
        got = to_np(got)
        nan = np.isnan(want)
        assert nan.sum() > 20
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert_bitwise(got[~nan], want[~nan])


@pytest.mark.parametrize("T,dim", [(8192, 1), (3 * 8192, 3)])
def test_chunk_reference_totals_are_chunk_sums(T, dim):
    """The chunk kernel's plain version takes the caller's (T, dim) rows and
    emits each chunk's pairwise float32 total (bitwise equal to a pairwise
    tree) and +inf at chunk starts."""
    data = _data(T, dim, 7)
    coeffs, totals = wavelet_cuda.maxlet_chunks_reference(torch.from_numpy(data))
    chunk = 1 << wavelet_cuda.CHUNK_BITS
    assert coeffs.shape == (T,) and totals.shape == (T // chunk, dim)
    for c in range(T // chunk):
        s = data[c * chunk : (c + 1) * chunk].copy()
        while s.shape[0] > 1:
            s = s[0::2] + s[1::2]
        assert_bitwise(totals[c], s[0])
        assert np.isinf(to_np(coeffs)[c * chunk])


@pytest.mark.parametrize("T", [8191, 8192, 8193, 16384, 16385, 3 * 8192 + 1, 2**17 - 1])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_composed_plain_kernels_bitwise_vs_golden_and_pallas(T, dim):
    """Tolerance: bitwise. The chunk kernel's plain version, then the cross
    kernel's, equal the golden model and the Pallas kernel in interpret
    mode; these sizes put the mask edge and the chunk edge on every side of
    a level. The chunk version alone already holds every coefficient but
    the chunk starts."""
    data = _data(T, dim, T + 31 * dim)
    want = gold.maxlet_transform(data)
    assert_bitwise(maxlet_transform_pallas(jnp.asarray(data), interpret=True), want)
    coeffs, totals = wavelet_cuda.maxlet_chunks_reference(torch.from_numpy(data))
    starts = np.arange(0, T, 1 << wavelet_cuda.CHUNK_BITS)
    inner = np.ones(T, dtype=bool)
    inner[starts] = False
    assert_bitwise(to_np(coeffs)[inner], want[inner])
    assert np.isinf(to_np(coeffs)[starts]).all()
    assert_bitwise(wavelet_cuda.maxlet_cross_reference(coeffs, totals), want)


@pytest.mark.parametrize("n_chunks,tail", [(2, 0), (5, 1), (37, -5), (64, 0), (65, 3)])
def test_cross_reference_matches_jax_cross_levels(n_chunks, tail):
    """Tolerance: bitwise. The cross kernel's plain version on given chunk
    totals writes, at every chunk start, what the JAX wrapper's cross-chunk
    levels and mask (wavelet_pallas.py:133-151) write there. Each chunk of
    the data holds its total at its first position and zeros elsewhere, so
    the Pallas kernel's totals are exactly those values."""
    chunk = 1 << wavelet_cuda.CHUNK_BITS
    T = (n_chunks - 1) * chunk + (chunk + tail if tail <= 0 else tail)
    totals = np.random.default_rng(n_chunks).normal(0, 50, size=(n_chunks, 2)).astype(np.float32)
    data = np.zeros((T, 2), dtype=np.float32)
    data[::chunk] = totals
    want = np.asarray(maxlet_transform_pallas(jnp.asarray(data), interpret=True))
    coeffs = torch.full((T,), np.nan)
    got = to_np(wavelet_cuda.maxlet_cross_reference(coeffs, torch.from_numpy(totals)))
    starts = np.arange(chunk, T, chunk)
    formed = ~np.isnan(got[starts])  # chunk starts the tree never forms keep their value
    assert np.isinf(want[starts][~formed]).all()
    assert formed.sum() >= n_chunks // 2
    assert_bitwise(got[starts][formed], want[starts][formed])
    assert np.isnan(np.delete(got, starts)).all()  # nothing else is written


def test_kernel_wrapper_refuses_host_data():
    with pytest.raises(ValueError, match="CUDA tensor"):
        wavelet_cuda.maxlet_chunks_cuda(torch.zeros(8192, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        wavelet_cuda.maxlet_cross_cuda(torch.zeros(8192), torch.zeros(1, 1))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises, it never falls back to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("maxlet", wavelet_cuda.SOURCES)
