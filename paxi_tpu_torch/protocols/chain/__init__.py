"""Chain replication (lane-major sim kernel)."""
