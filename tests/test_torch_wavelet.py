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
    tensor: padding, chunk layout, cross-chunk levels and mask around the
    kernel's plain version) equal the JAX level-wise transform, the Pallas
    kernel in interpret mode and the golden model."""
    data = _data(T, dim, T * 10 + dim)
    want = gold.maxlet_transform(data)
    assert_bitwise(jwav.maxlet_transform(jnp.asarray(data)), want)
    assert_bitwise(maxlet_transform_pallas(jnp.asarray(data), interpret=True), want)
    x = torch.from_numpy(data)
    assert_bitwise(wavelet.maxlet_transform(x), want)
    before = wavelet_cuda.maxlet_transform_cuda.launches
    assert_bitwise(wavelet_cuda.maxlet_transform_cuda(x), want)
    assert wavelet_cuda.maxlet_transform_cuda.launches == before  # CPU: no kernel


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
    """The kernel's plain version emits each chunk's pairwise float32 total
    (bitwise equal to a pairwise tree) and +inf at chunk starts."""
    data = _data(T, dim, 7)
    coeffs, totals = wavelet_cuda.maxlet_chunks_reference(
        torch.from_numpy(np.ascontiguousarray(data.T))
    )
    chunk = 1 << wavelet_cuda.CHUNK_BITS
    for c in range(T // chunk):
        s = data[c * chunk : (c + 1) * chunk].copy()
        while s.shape[0] > 1:
            s = s[0::2] + s[1::2]
        assert_bitwise(totals[c], s[0])
        assert np.isinf(to_np(coeffs)[c * chunk])


def test_kernel_wrapper_refuses_host_data():
    with pytest.raises(ValueError, match="CUDA tensor"):
        wavelet_cuda.maxlet_chunks_cuda(torch.zeros(1, 8192))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises, it never falls back to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("maxlet", wavelet_cuda.SOURCES)
