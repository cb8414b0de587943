"""SDPaxos (lane-major sim kernel)."""
