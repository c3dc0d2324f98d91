"""Entry points of the port: one full sweep as a callable, and a dry
run of the sharded engine over n devices. The counterparts of the JAX
package's __graft_entry__.py (``entry`` :16-70, ``dryrun_multichip``
:73-132).

    from hammlet_tpu_torch.entry import entry, dryrun_multichip
    step, args = entry()
    model = step(*args)          # (theta_mean, theta_var, A, pi) after a sweep
    dryrun_multichip(4)          # P = 4 shards: one per card on a host with 4
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synth(T: int = 100_000, seed: int = 0) -> np.ndarray:
    """__graft_entry__.py's data: segments of 300 in three states with means
    {0, 5, -5}, unit noise."""
    rng = np.random.default_rng(seed)
    means = np.array([0.0, 5.0, -5.0])
    state = rng.integers(0, 3, size=max(1, T // 300))
    reps = np.full(len(state), 300)
    reps[-1] = T - 300 * (len(state) - 1)
    mu = np.repeat(means[state], reps)
    return (mu + rng.normal(0, 1, size=T)).astype(np.float32)


def entry():
    """(step, example_args): one full Gibbs sweep (blocks -> FB state draw
    -> accumulate_sweep_stats -> resample_model, samplers/sweep.gibbs_sweep)
    on the flagship 3-state univariate CNV model, on one device (the card,
    or the CPU under HAMMLET_TORCH_DEVICE=cpu). ``step(generator, theta_mean, theta_var, A, pi)``
    returns the new model's four tensors."""
    from hammlet_tpu_torch.models.hmm import HMMState
    from hammlet_tpu_torch.runner import make_engine
    from hammlet_tpu_torch.samplers.sweep import gibbs_sweep, make_generator

    eng = make_engine(_synth(), nr_params=3, seed=0)
    cand_pos, cand_rank = eng._candidates()

    def step(generator, theta_mean, theta_var, A, pi):
        model = HMMState(theta_mean, theta_var, A, pi)
        new_model, _, _ = gibbs_sweep(
            generator, model, eng.priors, eng.ing.ranked, cand_pos, cand_rank,
            eng.ing.prefix, eng.buffers, method="F", nr_params=3,
            mapping=eng._mapping, cell_bits=eng.ing.cell_bits, record=False,
        )
        return tuple(new_model)

    m = eng.model
    example_args = (make_generator(eng.device, 0, 0), m.theta_mean, m.theta_var, m.A, m.pi)
    return step, example_args


def dryrun_shards(n_shards: int, device: str | None = None) -> int:
    """The sharded engine with P = ``n_shards`` over the processes of the
    group when there is one (else on ``device``, None: this process's
    device): one recorded FB sweep, then one mixture sweep. Every process
    calls it; returns the recorded sweeps, which every position must count
    exactly once."""
    from hammlet_tpu_torch.parallel.mesh import position_mesh
    from hammlet_tpu_torch.parallel.sharded import make_sharded_engine

    eng = make_sharded_engine(
        _synth(T=4096, seed=1), mesh=position_mesh(n_shards, device), nr_params=3, seed=0
    )
    eng.run("F", 1, 1)  # one recorded FB sweep end-to-end
    eng.run("M", 1, 0)  # and one mixture sweep
    per_position = eng.marginal_counts.sum(axis=0)  # a collective
    assert per_position.min() == per_position.max() == 1, "one recorded sweep per position"
    return int(per_position.max())


def dryrun_multichip(n_devices: int) -> None:
    """The sharded engine with P = ``n_devices`` shards, one recorded FB
    sweep and one mixture sweep. With at least n_devices > 1 cards it runs
    in n_devices processes of one card each (parallel/launch.py), else in
    this process. On a host without a card it runs on the CPU, which it asks
    for by name, and with n_devices >= 2 it also runs the CLI in two gloo
    processes (parallel/mh_worker.py, HAMMLET_TORCH_DEVICE=cpu), streaming
    ingest from a shared file, one writer, and checks that the marginals
    cover T."""
    from hammlet_tpu_torch.device import DEVICE_VAR
    from hammlet_tpu_torch.parallel import distributed, launch

    cards = distributed.card_count()
    if n_devices > 1 and cards >= n_devices:
        rc, recorded = launch.run_on_cards("hammlet_tpu_torch.entry:dryrun_shards", n_devices,
                                           (n_devices,))
        assert rc == 0 and recorded == 1, f"{n_devices} processes: exit code {rc}"
    else:
        dryrun_shards(n_devices, "cpu" if cards == 0 else None)

    if cards == 0 and n_devices >= 2:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "PYTHONPATH": _REPO, DEVICE_VAR: "cpu"}
        for name in ("HAMMLET_NUM_PROCESSES", "HAMMLET_COORDINATOR", "HAMMLET_PROCESS_ID",
                     "HAMMLET_LOCAL_DEVICES"):
            env.pop(name, None)
        with tempfile.TemporaryDirectory() as out:
            datafile = os.path.join(out, "data.csv")
            np.savetxt(datafile, _synth(T=2000, seed=7), fmt="%.6f")
            shared = os.path.join(out, "mh-")
            procs = [
                subprocess.Popen(
                    [sys.executable, "-m", "hammlet_tpu_torch.parallel.mh_worker",
                     str(pid), "2", str(port), datafile, shared,
                     str(max(n_devices // 2, 1)), "M", "4", "0", "F", "6", "2"],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                )
                for pid in range(2)
            ]
            try:
                logs = [p.communicate(timeout=540)[0].decode() for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log[-2000:]
            assert sum("primary=True" in log for log in logs) == 1, logs
            rows = [line.split("\t")
                    for line in open(shared + "marginals.csv").read().splitlines()]
            assert sum(int(r[0]) for r in rows) == 2000, "marginals cover T"
