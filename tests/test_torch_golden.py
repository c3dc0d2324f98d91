"""The port's copy of the golden model (hammlet_tpu_torch/golden/) against
the JAX package's (hammlet_tpu/golden/): every function on the same seeded
numpy inputs. Tolerance: exact, bit for bit, for every function (the
integer and maxlet results, and the float ones: both copies run the same
numpy operations in the same order)."""

import os
import stat

import numpy as np
import pytest

from hammlet_tpu.golden import parity as jpar
from hammlet_tpu.golden import reference as jref
from hammlet_tpu_torch.golden import parity as tpar
from hammlet_tpu_torch.golden import reference as tref


def _data(T=3000, dim=1, seed=0):
    rng = np.random.default_rng(seed)
    mu = np.repeat(rng.choice([0.0, 3.0, -2.0], size=(T // 100 + 1, dim)), 100, axis=0)[:T]
    return (mu + rng.normal(0, 1, size=(T, dim))).astype(np.float32)


def _blocks(seed=1, B=12, dim=1):
    rng = np.random.default_rng(seed)
    N = rng.integers(1, 30, size=B)
    sums = rng.normal(0, 10, size=(B, dim))
    sumsqs = np.abs(sums) ** 2 / N[:, None] + rng.uniform(1, 5, size=(B, dim)) * N[:, None]
    return sums, sumsqs, N


def _model(K=3, seed=2):
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(K) * 2, size=K)
    pi = rng.dirichlet(np.ones(K))
    return np.array([-2.0, 0.0, 3.0])[:K], np.array([1.1, 0.9, 1.3])[:K], A, pi


def _fb(mod, use_self):
    sums, sumsqs, N = _blocks()
    mean, var, A, pi = _model()
    mapping = np.arange(3)[:, None]
    cols = mod.fb_forward_columns(sums, sumsqs, N, mean, var, A, pi, mapping, use_self)
    draws = [
        mod.fb_gibbs_sweep(sums, sumsqs, N, mean, var, A, pi, mapping,
                           np.random.default_rng(5), use_self)
        for _ in range(3)
    ]
    return (*cols, *draws)


def _weights(mod, dim):
    return mod.breakpoint_weights(mod.maxlet_transform(_data(4099, dim, 3)))


CASES = {
    "maxlet_transform dim 1": lambda m: m.maxlet_transform(_data(3000, 1)),
    "maxlet_transform dim 3 T=8193": lambda m: m.maxlet_transform(_data(8193, 3, 4)),
    "maxlet_transform 1-D input": lambda m: m.maxlet_transform(_data(777)[:, 0]),
    "breakpoint_weights dim 1": lambda m: _weights(m, 1),
    "breakpoint_weights dim 2": lambda m: _weights(m, 2),
    "block_starts": lambda m: m.block_starts(_weights(m, 1), 2.5),
    "block_starts above every weight": lambda m: m.block_starts(_weights(m, 1), 1e6),
    "block_stats": lambda m: m.block_stats(_data(4099, 2, 3), m.block_starts(_weights(m, 1), 2.0)),
    "noise_std_estimate": lambda m: m.noise_std_estimate(m.maxlet_transform(_data())),
    "nig_posterior": lambda m: m.nig_posterior((2.0, 0.3, 0.1, 0.05), 12.5, 40.25, 9),
    "nig_posterior no counts": lambda m: m.nig_posterior((2.0, 0.3, 0.1, 0.05), 0.0, 0.0, 0),
    "nig_posterior guard": lambda m: m.nig_posterior((2.0, 0.3, 0.1, 0.05), 30.0, 1.0, 4),
    "nig_autoprior": lambda m: m.nig_autoprior(0.2, 0.9, 0.3, 2.5),
    "autoprior_from_blocks": lambda m: m.autoprior_from_blocks(
        0.2, 0.9, _data(), _weights(m, 1)[:3000],
        m.noise_std_estimate(m.maxlet_transform(_data()))),
    "fb_forward_columns + fb_gibbs_sweep": lambda m: _fb(m, True),
    "fb without self-transitions": lambda m: _fb(m, False),
    "mixture_sweep": lambda m: m.mixture_sweep(
        *_blocks(3, B=20), *_model()[:2], np.arange(3)[:, None], 3, np.random.default_rng(8)),
    "accumulate_counts": lambda m: m.accumulate_counts(
        np.random.default_rng(4).integers(0, 3, 25), _blocks(B=25)[2], 3),
}


def _assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(
        got.view(np.uint8) if got.dtype.kind == "f" else got,
        want.view(np.uint8) if want.dtype.kind == "f" else want,
    )


@pytest.mark.parametrize("case", CASES)
def test_reference_matches_jax_golden(case):
    """Exact: the port's golden.reference gives the JAX package's results,
    float bits included."""
    _assert_same(CASES[case](tref), CASES[case](jref))


# a stand-in for the reference binary: writes a marginals file for -o PREFIX
# .csv whose counts depend on -R
_FAKE_REF = """#!{python}
import sys
a = sys.argv
seed, prefix = int(a[a.index("-R") + 1]), a[a.index("-o") + 1]
rows = [(40, 10 - seed, seed, 0), (25, seed, 10 - seed, 0), (35, 2, 3, 5)]
with open(prefix + "marginals.csv", "w") as fh:
    fh.write("".join("\\t".join(map(str, r)) + "\\n" for r in rows))
"""


@pytest.mark.parametrize("fn", ["read_marginals", "tv_aligned", "run_reference",
                                "parity_report", "parity_bound"])
def test_parity_matches_jax_golden(fn, tmp_path):
    """Exact: the port's golden.parity gives the JAX package's results, with
    a stand-in reference binary for the functions that run one."""
    import sys

    ref = tmp_path / "ref"
    ref.write_text(_FAKE_REF.format(python=sys.executable))
    ref.chmod(ref.stat().st_mode | stat.S_IXUSR)
    (tmp_path / "m.csv").write_text("3\t1\t2\n5\t0\t3\n2\t3\t0\n")
    rng = np.random.default_rng(0)
    p, q = rng.dirichlet(np.ones(3), size=50), rng.dirichlet(np.ones(3), size=50)
    ours = rng.dirichlet(np.ones(3), size=100)

    def call(mod, out):
        os.makedirs(out, exist_ok=True)
        return {
            "read_marginals": lambda: mod.read_marginals(tmp_path / "m.csv"),
            "tv_aligned": lambda: mod.tv_aligned(p, q),
            "run_reference": lambda: mod.run_reference(
                str(ref), "d.csv", out, 3, ["F", "10", "2"], ["3"]),
            "parity_report": lambda: mod.parity_report(
                str(ref), "d.csv", out, ["F", "10", "2"], ["3"], ours),
            "parity_bound": lambda: mod.parity_bound(
                {"envelope_mean": 0.031, "envelope_std": 0.004}),
        }[fn]()

    got, want = call(tpar, str(tmp_path / "t")), call(jpar, str(tmp_path / "j"))
    if isinstance(want, dict):
        assert got == want
    else:
        _assert_same(got, want)
