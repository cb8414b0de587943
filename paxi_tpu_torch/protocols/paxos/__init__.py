"""Multi-Paxos (lane-major sim kernel)."""
