"""hammlet_tpu_torch — PyTorch/CUDA port of hammlet_tpu for NVIDIA Hopper.

Wavelet-compressed Forward-Backward Gibbs sampling of Bayesian Hidden Markov
Models, with the same algorithms, layouts and public names as the JAX
package ``hammlet_tpu`` (the reference it is tested against):

- ops/: Haar maxlet transform, breakpoint weights (plain torch) and the
  hand-written Hopper maxlet kernels (csrc/maxlet.cu); block extraction and
  O(1) block statistics from cell-structured prefix sums.
- models/: conjugate NIG / Dirichlet updates and the model state.
- samplers/: FB-Gibbs (prefix matrix products + random-map composition),
  mixture draws, and the Gibbs sweep with on-device marginal recording.
- runner.py: ingest -> auto-priors -> ``-i`` scheme interpreter with the block
  capacity ladder and overflow replay.

This package imports torch and never jax or hammlet_tpu. Importing the
package itself imports neither, so that the numpy tools (tools/, pyhammlet/)
start without torch.
"""

__version__ = "0.1.0"

_LAZY = ("HMMPriors", "HMMState", "ModelSpec")  # from models.hmm, at first use


def __getattr__(name: str):
    if name in _LAZY:
        from hammlet_tpu_torch.models import hmm

        return getattr(hmm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
