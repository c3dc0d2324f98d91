"""The port's entry points (hammlet_tpu_torch/entry.py) on the CPU,
the counterparts of __graft_entry__.py: one full sweep as a callable, and
the sharded dry run with its two-process gloo run of the CLI."""

import torch

from _torch_helpers import cpu_requested  # noqa: F401

from hammlet_tpu_torch import entry as tentry
from hammlet_tpu_torch.models.hmm import HMMState

torch.set_num_threads(1)


def test_entry_runs_one_sweep():
    """``step(*example_args)`` runs one full FB sweep and returns a new
    finite model of the flagship shapes (3 states, univariate); the same
    generator seed gives the same model."""
    step, args = tentry.entry()
    assert isinstance(args[0], torch.Generator) and len(args) == 5
    model = HMMState(*step(*args))
    assert [tuple(t.shape) for t in model] == [(3,), (3,), (3, 3), (3,)]
    assert all(torch.isfinite(t).all() for t in model)
    assert torch.allclose(model.A.sum(dim=1), torch.ones(3))
    assert not torch.equal(model.theta_mean, args[1])
    gen = torch.Generator().manual_seed(args[0].initial_seed())
    assert all(torch.equal(a, b) for a, b in zip(step(gen, *args[1:]), model))


def test_dryrun_multichip_two_shards():
    """dryrun_multichip(2): P = 2 in this process (no card here), then the
    CLI in two gloo processes through parallel/mh_worker.py; it raises on
    any failure."""
    tentry.dryrun_multichip(2)
