"""The port's HAMMLET_DEBUG invariant checks (hammlet_tpu_torch/debug.py)
against the JAX package's (hammlet_tpu/debug.py), and in the engine: an
injected numerics fault fails loudly at the chunk's host sync, and with the
switch off the sweep issues none of the checks' ops."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_helpers import synth_segments
from hammlet_tpu import debug as jdebug
from hammlet_tpu.models.hmm import HMMState as JHMMState
from hammlet_tpu_torch import convert, debug, runner
from hammlet_tpu_torch.samplers import sweep

torch.set_num_threads(1)


def _model(K=3, **poison):
    """A healthy model of P = 3 emission parameters and K states (K = 27:
    three tracks, -s C 3 3), with ``poison`` written into entry 1 of the
    named fields."""
    rng = np.random.default_rng(K)
    m = dict(
        theta_mean=np.array([-1.0, 0.5, 2.0], np.float32),
        theta_var=np.array([0.9, 1.1, 0.7], np.float32),
        A=rng.dirichlet(np.ones(K), size=K).astype(np.float32),
        pi=rng.dirichlet(np.ones(K)).astype(np.float32),
    )
    for field, value in poison.items():
        m[field] = m[field].copy()
        m[field].flat[1] = value
    return m


POISONS = [
    {},
    {"theta_mean": np.nan},
    {"theta_mean": np.inf},
    {"theta_var": -1.0},
    {"theta_var": 0.0},
    {"theta_var": np.nan},
    {"A": np.nan},
    {"pi": np.inf},
    {"theta_mean": np.nan, "theta_var": -2.0, "A": np.nan},
]


@pytest.mark.parametrize("K", [3, 27])
@pytest.mark.parametrize("poison", POISONS, ids=lambda p: "+".join(p) or "healthy")
@pytest.mark.parametrize("bad_stats", [False, True])
def test_model_error_bits_match_jax(poison, bad_stats, K):
    """Exact: the same bitmask as the JAX package for each violated
    invariant, and the same error text; at K = 3 and at K = 27 ((27, 27)
    transitions, block statistics of three tracks)."""
    m = _model(K, **poison)
    bstats = np.ones((1 if K == 3 else 3, 2, 8), np.float32)
    if bad_stats:
        bstats[0, 1, 5] = np.inf
    want = int(jdebug.model_error_bits(JHMMState(**{k: jnp.asarray(v) for k, v in m.items()}), jnp.asarray(bstats)))
    got = debug.model_error_bits(convert.hmm_state(SimpleNamespace(**m)), torch.from_numpy(bstats))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == want
    assert int(debug.model_error_bits(convert.hmm_state(SimpleNamespace(**m)))) == want & ~debug.ERR_BLOCK_STATS
    if want:
        with pytest.raises(FloatingPointError) as jexc:
            jdebug.raise_on_error(want)
        with pytest.raises(FloatingPointError) as texc:
            debug.raise_on_error(int(got))
        assert str(texc.value) == str(jexc.value)
    else:
        debug.raise_on_error(0)


def _poison(model, field, value):
    t = getattr(model, field).clone()
    t[0] = value
    return model._replace(**{field: t})


@pytest.fixture
def engine():
    data = synth_segments(1500, 0)[0]
    eng = runner.make_engine(data, nr_params=2, seed=1, device="cpu")
    return eng


def test_nan_mean_fails_loudly(engine, monkeypatch):
    monkeypatch.setenv("HAMMLET_DEBUG", "1")
    engine.run("F", 2, 0)  # healthy sweeps pass
    engine.model = _poison(engine.model, "theta_mean", float("nan"))
    with pytest.raises(FloatingPointError, match="emission mean"):
        engine.run("F", 2, 0)


def test_negative_variance_fails_loudly(engine, monkeypatch):
    monkeypatch.setenv("HAMMLET_DEBUG", "1")
    engine.model = _poison(engine.model, "theta_var", -1.0)
    with pytest.raises(FloatingPointError, match="variance"):
        engine.run("F", 2, 0)


def test_debug_off_raises_nothing(engine, monkeypatch):
    """HAMMLET_DEBUG=0: a poisoned mean runs through unchecked, as in the
    JAX package's production programs."""
    monkeypatch.setenv("HAMMLET_DEBUG", "0")
    engine.model = _poison(engine.model, "theta_mean", float("nan"))
    engine.run("F", 2, 0)


def test_debug_off_issues_no_check_ops(engine, monkeypatch):
    """With the switch off a recording chunk never reaches the checks (the
    check function is replaced by one that raises); with it on, every sweep
    does, and a healthy chunk reports error bits 0 in diag[2]."""

    def boom(*args, **kwargs):
        raise AssertionError("model_error_bits called with HAMMLET_DEBUG=0")

    engine.run("M", 4, 0)
    cand_pos, cand_rank = engine._candidates()

    def chunk(dbg):
        return sweep.gibbs_phase(
            engine.seed, 99, engine.model, engine.priors, engine.ing.ranked,
            cand_pos, cand_rank, engine.ing.prefix, engine.buffers.clone(),
            None, method="F", nr_params=2, mapping=engine._mapping,
            use_self_transitions=True, n_iters=4, thinning=2,
            cell_bits=engine.ing.cell_bits, record=True, want_blocks=True,
            debug=dbg,
        )

    healthy = chunk(True)
    assert int(healthy[3][2]) == 0
    with monkeypatch.context() as m:
        m.setattr(debug, "model_error_bits", boom)
        m.setenv("HAMMLET_DEBUG", "0")
        quiet = chunk(debug.debug_enabled())
        assert int(quiet[3][2]) == 0
        engine.run("F", 4, 2)
        m.setenv("HAMMLET_DEBUG", "1")
        with pytest.raises(AssertionError, match="HAMMLET_DEBUG=0"):
            engine.run("F", 4, 2)
    # the checks change nothing the chunk computes
    for a, b in zip(healthy[4:7], quiet[4:7]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
