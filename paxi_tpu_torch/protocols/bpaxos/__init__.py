"""BPaxos (lane-major sim kernel)."""
