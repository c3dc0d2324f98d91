"""Shared helpers for the tests that hold hammlet_tpu_torch (the PyTorch
port) against hammlet_tpu (the JAX reference). Inputs are made with numpy
from a seed and handed to both packages as numpy arrays."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hammlet_tpu_torch.device import DEVICE_VAR


def to_np(x) -> np.ndarray:
    """numpy copy of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch(x, dtype=None) -> torch.Tensor:
    """CPU tensor holding a writable copy of a JAX/numpy array."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def assert_bitwise(got, want) -> None:
    """Every float32 value has the same bits (inf included; no NaN)."""
    g = np.ascontiguousarray(to_np(got), dtype=np.float32)
    w = np.ascontiguousarray(to_np(want), dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def assert_ulp(got, want, max_ulp: int) -> None:
    """float32 values at most ``max_ulp`` units in the last place apart
    (same sign assumed: the distance of the bit patterns)."""
    g = np.ascontiguousarray(to_np(got), dtype=np.float32).view(np.int32)
    w = np.ascontiguousarray(to_np(want), dtype=np.float32).view(np.int32)
    dist = np.abs(g.astype(np.int64) - w.astype(np.int64))
    assert dist.max() <= max_ulp, (dist.max(), to_np(got), to_np(want))


@pytest.fixture(autouse=True, scope="module")
def cpu_requested():
    """HAMMLET_TORCH_DEVICE=cpu for every test of a module that imports
    this fixture, and so for the processes those tests start: the port
    runs on the CPU only when asked for it by name (the JAX package's
    tests ask with JAX_PLATFORMS=cpu). Restored after the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(DEVICE_VAR, "cpu")
        yield


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, decided when the test runs (never at import): tests that
    take this fixture skip without CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def toy_problem(B=12, K=3, dim=1, seed=0, pad=5):
    """Random block stats + model for a small HMM (tests/test_samplers.py's
    _toy_problem); returns padded numpy arrays."""
    from hammlet_tpu_torch.models.mapping import combinations_mapping

    rng = np.random.default_rng(seed)
    N = rng.integers(1, 20, size=B)
    means_true = rng.choice([0.0, 3.0, -2.0], size=B)
    sums = np.zeros((B, dim))
    sumsqs = np.zeros((B, dim))
    for b in range(B):
        x = rng.normal(means_true[b], 1.0, size=(N[b], dim))
        sums[b] = x.sum(axis=0)
        sumsqs[b] = (x * x).sum(axis=0)
    theta_mean = np.array([-2.0, 0.0, 3.0], dtype=np.float32)[:K]
    theta_var = np.array([1.1, 0.9, 1.3], dtype=np.float32)[:K]
    A = rng.dirichlet(np.ones(K) * 2, size=K).astype(np.float32)
    pi = rng.dirichlet(np.ones(K)).astype(np.float32)
    mapping = combinations_mapping(dim, K)[:, :dim]
    Bcap = B + pad
    stats = np.zeros((Bcap, dim, 2), dtype=np.float32)
    stats[:B, :, 0] = sums
    stats[:B, :, 1] = sumsqs
    sizes = np.zeros(Bcap, dtype=np.int32)
    sizes[:B] = N
    return dict(
        B=B, Bcap=Bcap, K=K, dim=dim, N=N, sums=sums, sumsqs=sumsqs,
        stats=stats, stats_t=np.ascontiguousarray(stats.transpose(1, 2, 0)),
        sizes=sizes, theta_mean=theta_mean, theta_var=theta_var,
        A=A, pi=pi, mapping=mapping,
    )


def sweep_like_matrices(K: int, R: int, B: int, seed: int) -> np.ndarray:
    """(K, K, R, B) float32 block matrices shaped like the sweep's
    M = A * exp(E - max E) (samplers/forward_backward.py:forward_columns_t):
    log weights E down to -110 below each column's max, so that about 1 %
    of the entries are subnormal, and about half of them exactly zero (the
    sweep's own: 52 % zeros, ~1 % subnormal)."""
    rng = np.random.default_rng(seed)
    A = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    E = rng.uniform(-110.0, 0.0, size=(K, R, B)).astype(np.float32)
    e = np.exp(E - E.max(axis=0, keepdims=True))
    e[(rng.random(e.shape) < 0.75) & (e < 1.0)] = 0.0
    return A[:, :, None, None] * e[None]


#: constructed resample noise: the cases the first-accepted-try vote must get right
VOTE_CASES = ("none", "only_last", "all", "nan_in_a_try")


def vote_noise(case: str, P: int, n: int, seed: int) -> tuple[np.ndarray, ...]:
    """Resample noise (proposal normals (8, n), acceptance uniforms (8, n),
    boost uniforms (n,), mean normals (P,)) built so that, at every Gamma
    shape, ``case`` decides which of the 8 tries are accepted: "none" (x =
    0, u = 1: the statistic is 0 and log u = 0 is not below it, so the
    draw is the mode); "only_last" (tries 0-6 as in "none", try 7 x in
    (-2, 2) and u = 1e-30); "all" (u = 1e-30: try 0 wins); "nan_in_a_try"
    (u = 1e-30, a NaN normal in try 0 of even shapes and a NaN uniform in
    tries 0-1 of odd ones: the first try without NaN wins)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(8, n)).astype(np.float32)
    u = np.full((8, n), 1e-30, np.float32)
    if case in ("none", "only_last"):
        x[:7 if case == "only_last" else 8] = 0.0
        u[:7 if case == "only_last" else 8] = 1.0
    elif case == "nan_in_a_try":
        x[0, 0::2] = np.nan
        u[:2, 1::2] = np.nan
    ub = rng.uniform(0.01, 1.0, size=n).astype(np.float32)
    z = rng.normal(size=P).astype(np.float32)
    return x, u, ub, z


def synth_segments(T: int, seed: int, seglen: int = 500, scale: float = 1.0):
    """bench.py's data recipe: segments of ``seglen`` positions in one of
    three states with means {0, 2, -2} * scale, unit noise.
    Returns (data, true states)."""
    rng = np.random.default_rng(seed)
    means = np.array([0.0, 2.0, -2.0]) * scale
    n_seg = max(1, T // seglen)
    state = rng.integers(0, 3, size=n_seg)
    reps = np.full(n_seg, seglen)
    reps[-1] = T - seglen * (n_seg - 1)
    data = np.repeat(means[state], reps) + rng.normal(0, 1, size=T)
    return data.astype(np.float32), np.repeat(state, reps)


def eager_engine(eng):
    """``eng`` (a runner.Engine) with every phase chunk run through the
    eager samplers.sweep.gibbs_phase: the plain version the graphed chunks
    (samplers/phase_graph.py) are held against; chip_smoke.py's helper."""
    from chip_smoke import eager_engine as eager

    return eager(eng)


def eager_sharded_engine(eng):
    """``eng`` (a parallel.sharded.ShardedEngine) with every phase chunk
    run through the eager parallel.sharded.sharded_phase, the plain version
    of its graphed chunks; chip_smoke.py's helper."""
    from chip_smoke import eager_sharded_engine as eager

    return eager(eng)


def fail_on_last_rank() -> None:
    """A parallel/launch.py ``run_on_cards`` target: the last process of the
    group raises while the others wait for it in a barrier."""
    import torch.distributed as dist

    if dist.get_rank() == dist.get_world_size() - 1:
        raise RuntimeError("the last process failed on purpose")
    dist.barrier()


class ThreadRanks:
    """The W processes of a group played by W threads of this process: the
    torch.distributed calls parallel/mesh.py makes (get_world_size,
    get_rank, all_reduce, and its all_gather), answered through a barrier.
    ``install(monkeypatch)`` routes mesh.py's calls here; ``run(fn)`` calls
    ``fn(rank)`` in W threads and returns the W results. A mesh of W
    thread ranks is ``PositionMesh(P, device, group=ranks)``."""

    def __init__(self, world: int):
        import threading

        self.world = world
        self.barrier = threading.Barrier(world, timeout=600)
        self.slots = [None] * world
        self.local = threading.local()

    def install(self, monkeypatch) -> None:
        from types import SimpleNamespace

        from hammlet_tpu_torch.parallel import mesh

        monkeypatch.setattr(mesh, "_all_gather", self.all_gather)
        monkeypatch.setattr(mesh, "dist", SimpleNamespace(
            get_world_size=self.get_world_size, get_rank=self.get_rank,
            all_reduce=self.all_reduce,
        ))

    def get_world_size(self, group=None) -> int:
        return self.world

    def get_rank(self, group=None) -> int:
        return self.local.rank

    def _exchange(self, x: torch.Tensor) -> list:
        self.slots[self.local.rank] = x.clone()
        if x.is_cuda:
            # as a real collective, ordered after the caller's queued work
            # (threads may queue on streams of their own: a graph warm-up)
            torch.cuda.current_stream(x.device).synchronize()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_gather(self, out: torch.Tensor, x: torch.Tensor, group=None) -> None:
        out.copy_(torch.cat(self._exchange(x)))

    def all_reduce(self, x: torch.Tensor, group=None) -> None:
        x.copy_(torch.stack(self._exchange(x)).sum(dim=0))

    def run(self, fn) -> list:
        import threading

        results, errors = [None] * self.world, []

        def body(rank):
            self.local.rank = rank
            try:
                results[rank] = fn(rank)
            except BaseException as exc:  # reported below; free the others
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
