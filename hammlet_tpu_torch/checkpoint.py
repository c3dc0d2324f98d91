"""Checkpoint / resume for sampling runs.

Port of hammlet_tpu/checkpoint.py, single-device and sharded. The complete sampler
state — RNG counter, model iterate, marginal count buffers, boundary union,
capacity, scheme position — is a small set of arrays saved as one .npz with
the JAX package's keys and dtypes, so either package reads the other's
files. Restoring reproduces the exact continuation: every sweep's generator
is seeded from (seed, chunk counter, sweep index), so a resumed chain is
bit-identical to an uninterrupted run of the same package.
"""

from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from hammlet_tpu_torch import convert


def _write_npz(path: str, state: dict) -> None:
    """np.savez to ``path`` atomically (a temporary file, fsynced, then
    renamed over the target)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **state)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _scheme_tokens(engine) -> np.str_:
    """The -i token list the scheme cursor indexes (resume rejects a
    mismatch: the cursor would skip or truncate the wrong ops)."""
    return np.str_(" ".join(getattr(engine, "ckpt_scheme_tokens", None) or []))


def _restore_cursor(engine, z) -> None:
    """Scheme cursor and token list (absent from older files)."""
    files = set(z.files)
    engine.scheme_op_index = int(z["scheme_op_index"]) if "scheme_op_index" in files else 0
    engine.scheme_op_done = int(z["scheme_op_done"]) if "scheme_op_done" in files else 0
    if "scheme_tokens" in files:
        s = str(z["scheme_tokens"])
        engine.ckpt_scheme_tokens = s.split(" ") if s else None


def save_checkpoint(engine, path: str) -> None:
    """Serialize an Engine's resumable state atomically."""
    model, buffers = engine.model, engine.buffers
    state = {
        "seed": np.int64(engine.seed),
        "sweep_counter": np.int64(engine.sweep_counter),
        "sweeps_completed": np.int64(engine.sweeps_completed),
        "capacity": np.int64(engine.capacity),
        "dynamic": np.bool_(engine._dynamic),
        "static_threshold": np.asarray(engine._static_threshold),
        "theta_mean": model.theta_mean.cpu().numpy(),
        "theta_var": model.theta_var.cpu().numpy(),
        "A": model.A.cpu().numpy(),
        "pi": model.pi.cpu().numpy(),
        "counts": buffers.counts.cpu().numpy(),
        "ever_boundary": buffers.ever_boundary.cpu().numpy(),
        "n_records": buffers.n_records.cpu().numpy(),
        "n_boundaries": buffers.n_boundaries.cpu().numpy(),
        "total_sweeps": np.float64(engine.total_sweeps),
        "scheme_op_index": np.int64(engine.scheme_op_index),
        "scheme_op_done": np.int64(engine.scheme_op_done),
        "scheme_tokens": _scheme_tokens(engine),
    }
    _write_npz(path, state)


def restore_checkpoint(engine, path: str) -> None:
    """Load state saved by save_checkpoint (of either package) into a
    freshly built Engine (same data/priors/spec/seed)."""
    with np.load(path) as z:
        if int(z["seed"]) != engine.seed:
            raise ValueError(
                f"checkpoint seed {int(z['seed'])} != engine seed {engine.seed}"
            )
        if z["counts"].shape != tuple(engine.buffers.counts.shape):
            raise ValueError("checkpoint shape mismatch (different data or model?)")
        files = set(z.files)
        engine.sweep_counter = int(z["sweep_counter"])
        engine.sweeps_completed = int(z["sweeps_completed"]) if "sweeps_completed" in files else 0
        engine.capacity = int(z["capacity"])
        engine._dynamic = bool(z["dynamic"])
        engine._static_threshold = float(z["static_threshold"])
        engine.model = convert.hmm_state(z.f, engine.device)
        saved = convert.record_buffers(
            SimpleNamespace(
                counts=z["counts"],
                ever_boundary=z["ever_boundary"],
                n_records=z["n_records"],
                n_boundaries=(
                    z["n_boundaries"] if "n_boundaries" in files
                    else np.int32(z["ever_boundary"].sum())
                ),
            ),
            engine.device,
        )
        # into the engine's own buffers: the engine's CUDA graphs
        # (samplers/phase_graph.py) record into those addresses
        for name in ("counts", "ever_boundary", "n_records", "n_boundaries"):
            getattr(engine.buffers, name).copy_(getattr(saved, name))
        # total_sweeps/sample_time are process-local throughput counters and
        # are not restored (a resumed process reports its own rate)
        _restore_cursor(engine, z)
    engine._last_ckpt = engine.sweeps_completed


def save_sharded_checkpoint(engine, path: str) -> None:
    """Serialize a ShardedEngine's resumable state (hammlet_tpu/checkpoint.py:113
    keys and dtypes): the marginal counts and the boundary union are
    gathered in global shard order, so the file does not depend on how the
    shards were spread over processes. The gather is a collective: every
    process calls this at the same point; only the primary writes."""
    from hammlet_tpu_torch.parallel.distributed import is_primary

    buf, mesh, T_local = engine.buffers, engine.mesh, engine.T_local
    counts = mesh.all_gather(buf.counts).cpu().numpy().reshape(-1)
    everb = mesh.all_gather(buf.everb[:, :T_local]).cpu().numpy().reshape(-1)
    if not is_primary():
        return
    model = engine.model
    _write_npz(path, {
        "seed": np.int64(engine.seed),
        "n_shards": np.int64(engine.n_shards),
        "sweep_counter": np.int64(engine.sweep_counter),
        "sweeps_completed": np.int64(engine.sweeps_completed),
        "cap_local": np.int64(engine.cap_local),
        "dynamic": np.bool_(engine._dynamic),
        "static_threshold": np.asarray(engine._static_threshold),
        "theta_mean": model.theta_mean.cpu().numpy(),
        "theta_var": model.theta_var.cpu().numpy(),
        "A": model.A.cpu().numpy(),
        "pi": model.pi.cpu().numpy(),
        "counts": counts,
        "everb": everb,
        "n_rec": buf.n_rec.cpu().numpy(),
        "n_bound": buf.n_bound.cpu().numpy(),
        "total_sweeps": np.float64(engine.total_sweeps),
        "scheme_op_index": np.int64(engine.scheme_op_index),
        "scheme_op_done": np.int64(engine.scheme_op_done),
        "scheme_tokens": _scheme_tokens(engine),
    })


def restore_sharded_checkpoint(engine, path: str) -> None:
    """Load state saved by save_sharded_checkpoint (of either package) into
    a freshly built ShardedEngine (same data/priors/spec/seed and number of
    shards; any number of processes). Each process takes its own shards'
    rows."""
    mesh, K, T_local = engine.mesh, engine.spec.nr_states, engine.T_local
    with np.load(path) as z:
        if int(z["seed"]) != engine.seed:
            raise ValueError(
                f"checkpoint seed {int(z['seed'])} != engine seed {engine.seed}"
            )
        if int(z["n_shards"]) != engine.n_shards:
            raise ValueError(
                f"checkpoint has {int(z['n_shards'])} shards, engine has "
                f"{engine.n_shards} (resume with the same -D)"
            )
        if z["counts"].shape != (engine.n_shards * K * T_local,):
            raise ValueError("checkpoint shape mismatch (different data or model?)")
        rows = slice(mesh.first_shard, mesh.first_shard + mesh.local_shards)
        counts = z["counts"].reshape(engine.n_shards, K * T_local)[rows]
        everb = np.zeros((mesh.local_shards, T_local + 1), dtype=bool)
        everb[:, :T_local] = z["everb"].reshape(engine.n_shards, T_local)[rows]
        engine.sweep_counter = int(z["sweep_counter"])
        engine.sweeps_completed = int(z["sweeps_completed"])
        engine.cap_local = int(z["cap_local"])
        engine._dynamic = bool(z["dynamic"])
        engine._static_threshold = float(z["static_threshold"])
        engine.model = convert.hmm_state(z.f, engine.device)
        # into the engine's own buffers: the engine's CUDA graphs
        # (samplers/phase_graph.py) record into those addresses
        buf = engine.buffers
        buf.counts.copy_(torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int32)))
        buf.everb.copy_(torch.from_numpy(everb))
        buf.n_rec.fill_(int(z["n_rec"]))
        buf.n_bound.fill_(int(z["n_bound"]) if "n_bound" in z.files else int(z["everb"].sum()))
        _restore_cursor(engine, z)
    engine._last_ckpt = engine.sweeps_completed
