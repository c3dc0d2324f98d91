"""Position-sharded engine of the port (hammlet_tpu/parallel/).

Only the host-side drain helper is ported so far
(``sharded._reassemble_block_rows``), which the single-device engine uses as
its P = 1 case; the sharded engine, its ingest and the multi-host runtime
on torch.distributed are still to come (ROADMAP.md).
"""
