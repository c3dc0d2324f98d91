"""Golden NumPy re-derivations of the reference algorithms.

The port's own copy of hammlet_tpu/golden/ (numpy only; importing anything
of hammlet_tpu would import jax). Small, deliberately literal
(streaming-order) implementations that pin the semantics the kernels and
samplers must reproduce: chip_smoke.py and tests/test_torch_cuda.py hold the
card's kernels and the FB sampler against them on a machine without JAX.
"""
