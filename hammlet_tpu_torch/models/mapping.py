"""State -> emission-parameter mapping (reference: src/Mapping.hpp:53-137).

``mapping[s, d]`` is the emission-parameter index used by state ``s`` for data
dimension ``d``. The ``combinations`` scheme enumerates all nrParams^nrDim
assignments as reversed base-nrParams numbers (Mapping.hpp:91-108).
"""

from __future__ import annotations

import numpy as np


def combinations_mapping(nr_data_dim: int, nr_params: int) -> np.ndarray:
    """(K, dim) int32 with K = nr_params ** nr_data_dim."""
    if nr_data_dim <= 0 or nr_params <= 0:
        raise ValueError("nr_data_dim and nr_params must be positive")
    K = nr_params**nr_data_dim
    if K <= 1:
        raise ValueError(
            "Requested parameters would yield an HMM with less than 2 states!"
        )
    out = np.zeros((K, nr_data_dim), dtype=np.int32)
    for s in range(K):
        n = s
        for d in range(nr_data_dim):
            out[s, d] = n % nr_params
            n //= nr_params
    return out
