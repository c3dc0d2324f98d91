"""Position-sharded engine of the port (hammlet_tpu/parallel/): the mesh of
shards over processes (mesh.py), the multi-process runtime on
torch.distributed (distributed.py), the bounded-memory sharded ingest
(ingest.py), the sharded sweep and engine (sharded.py) and the worker of a
multi-process test run (mh_worker.py)."""

from hammlet_tpu_torch.parallel.mesh import position_mesh  # noqa: F401
from hammlet_tpu_torch.parallel.sharded import ShardedEngine, make_sharded_engine  # noqa: F401
