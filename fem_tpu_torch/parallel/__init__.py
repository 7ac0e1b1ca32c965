"""Multi-device pieces: per-shard mesh views (partition), the device mesh and
its collectives (mesh), their counter (commcount) and the element-sharded
operator (ops)."""
