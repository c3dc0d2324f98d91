"""The port's position-sharded engine on multi-track data (-s C L D) against
the JAX package's ShardedEngine: K = 9 (two tracks, configuration 4), 27
(three tracks) and 81 (four tracks), the data of chip_smoke.py's [states9],
[states27] and [states81] at a small T. Both engines hold P = 4 shards: the
port in one process on the CPU, the JAX package on four devices of the
conftest's 8-device virtual CPU mesh. On a card the same sweeps take the
team (K = 9), wide (K = 27) and tiled (K = 81, with the grouped suffix)
scan instances and chip_smoke.py's [sharded_tracks] holds them there; here
their plain versions run. Every test names the JAX function it holds the
port against, and the tolerance."""

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import cpu_requested, to_np  # noqa: F401
from chip_smoke import (MAP_AGREEMENT_MIN, config4_steps, map_agreement, recorded_sweeps,
                        states27_steps, states81_steps)
from hammlet_tpu import checkpoint as jckpt
from hammlet_tpu.parallel import sharded as jsh
from hammlet_tpu.parallel.mesh import position_mesh as jax_mesh
from hammlet_tpu_torch.parallel import sharded as tsh
from test_torch_sharded import (check_compaction_matches_jax, check_jax_checkpoint_restores,
                                check_resume_bitwise, check_sweep_given_jax_draws,
                                check_thread_ranks)

torch.set_num_threads(1)

P = 4  # shards, as [sharded_tracks] holds on one card
SEED = 0  # both engines', at every K
# K -> (data, emission parameters per track, tracks, T, scheme): the JAX run of each K is shared
# by the tests below (module fixture). T is the first of 12,000, 20,000 and 40,000 at which the
# JAX engine's MAP agreement cleared 0.95 at each of seeds 0-3 (PERF.md): at K = 9 it stayed in
# a local mode at seed 0 at 12,000 (0.80) and 20,000 (0.52)
CASES = {
    9: (config4_steps, 3, 2, 40_000, "M 32 0 F 32 4"),
    27: (states27_steps, 3, 3, 12_000, "M 32 0 F 32 4"),
    81: (states81_steps, 3, 4, 4_000, "M 8 0 F 8 2"),
}


def _port(data, K, n=P, seed=SEED, **kw):
    _, n_params, dim, *_ = CASES[K]
    return tsh.make_sharded_engine(data, n_devices=n, nr_params=n_params, nr_data_dim=dim,
                                   seed=seed, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """K -> the JAX ShardedEngine on P devices after its CASES scheme (run
    at first use), its data, truth, marginals and a sharded checkpoint of
    its finished state."""
    assert len(jax.devices()) >= P
    runs: dict = {}

    def get(K):
        if K not in runs:
            steps, n_params, dim, T, scheme = CASES[K]
            tmp = tmp_path_factory.mktemp(f"jax{K}")
            data, truth = steps(T)
            je = jsh.make_sharded_engine(data, mesh=jax_mesh(P), nr_params=n_params,
                                         nr_data_dim=dim, seed=SEED)
            assert je.spec.nr_states == K
            je.run_scheme(scheme.split())
            jckpt.save_sharded_checkpoint(je, str(tmp / "jax.npz"))
            runs[K] = dict(data=data, truth=truth, engine=je, tmp=tmp, scheme=scheme,
                           marginals=jsh.compact_sharded_marginals(je))
        return runs[K]

    return get


# ---- the sweep body given JAX's draws -----------------------------------------


@pytest.mark.parametrize("method", ["F", "M"])
@pytest.mark.parametrize("K", [9, 27, 81])
def test_sweep_given_jax_draws_multitrack(jax_runs, K, method):
    """test_torch_sharded.check_sweep_given_jax_draws at K states on K's
    tracks (the statistics of each track routed through the mapping), on
    the JAX run's settled state, P = 4 shards: block counts, sizes, states,
    recorded counts, boundary union, n_rec and n_bound exact; the sweep
    statistics against the global chain's: counts exact, sums of squares
    within rtol 1e-5, signed sums within 1e-5 of the sum of |x|."""
    run = jax_runs(K)
    check_sweep_given_jax_draws(run["engine"], run["data"], _port(run["data"], K),
                                str(run["tmp"] / "jax.npz"), P, jax.random.PRNGKey(123 + K),
                                method)


# ---- whole runs, the records, checkpoints ----------------------------------------


def _agreement(starts, counts, truth):
    starts, counts = np.asarray(starts), np.asarray(counts)
    return map_agreement(np.diff(np.append(starts, len(truth))), counts, truth)


@pytest.mark.parametrize("K", [9, 27])
def test_map_agreement_beside_jax(jax_runs, K):
    """Statistical, vs the JAX ShardedEngine on the same data, seed and
    scheme (the random streams differ): each engine's MAP states agree with
    the true states on >= MAP_AGREEMENT_MIN of the positions
    (chip_smoke.map_agreement, linear_sum_assignment over the K labels),
    the gate [sharded_tracks] holds the card to at T = 4M, and the two
    agreements are within 0.02 of each other; the port's marginal rows have
    K columns and count every recorded sweep. Both engines at seed 0, T as
    CASES says."""
    run = jax_runs(K)
    e = _port(run["data"], K)
    e.run_scheme(run["scheme"].split())
    starts, counts = tsh.compact_sharded_marginals(e)
    assert counts.shape[1] == K and set(counts.sum(axis=1).tolist()) == {8}
    got = _agreement(starts, counts, run["truth"])
    want = _agreement(*run["marginals"], run["truth"])
    assert got >= MAP_AGREEMENT_MIN and want >= MAP_AGREEMENT_MIN, (got, want)
    assert abs(got - want) <= 0.02, (got, want)


def test_compaction_matches_jax_at_k27(jax_runs):
    """test_torch_sharded.check_compaction_matches_jax on the JAX K = 27
    run's recorded buffers (exact)."""
    run = jax_runs(27)
    check_compaction_matches_jax(run["engine"], _port(run["data"], 27), P, 27)


def test_jax_sharded_checkpoint_restores_into_port_at_k27(jax_runs, tmp_path):
    """test_torch_sharded.check_jax_checkpoint_restores on the JAX K = 27
    run's checkpoint (exact restore, same keys and dtypes, the run
    continues, rows of 27 states sum to the recorded sweeps)."""
    run = jax_runs(27)
    check_jax_checkpoint_restores(
        str(run["tmp"] / "jax.npz"), run["data"],
        lambda n, **kw: _port(run["data"], 27, n, **kw),
        P, 27, recorded_sweeps(run["scheme"]), tmp_path)


def test_resume_bitwise_equal_at_k27(tmp_path):
    """test_torch_sharded.check_resume_bitwise at K = 27 on three tracks,
    F 16 4 (exact)."""
    data = states27_steps(4_000)[0]
    check_resume_bitwise(lambda: _port(data, 27, seed=9), tmp_path, 16)


def test_thread_ranks_match_one_process_at_k9(tmp_path, monkeypatch):
    """test_torch_sharded.check_thread_ranks at K = 9 (configuration 4's
    two tracks), two ranks (exact): the gathers of (S, 9, 9) shard totals,
    (S, 9) maps and the statistics do not depend on the shards per
    process."""
    check_thread_ranks(tmp_path, monkeypatch, config4_steps(20_000)[0], 2, 9, "M 16 0 F 16 4",
                       nr_params=3, nr_data_dim=2)
