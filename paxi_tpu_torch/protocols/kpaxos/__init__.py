"""KPaxos (lane-major sim kernel)."""
