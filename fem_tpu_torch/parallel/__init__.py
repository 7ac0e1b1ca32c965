"""Multi-device pieces: per-shard mesh views (partition), the device mesh and
its collectives (mesh), their counter (commcount), the element-sharded
operator (ops) and the DOF-sharded halo-gather operator (halo_gather)."""
