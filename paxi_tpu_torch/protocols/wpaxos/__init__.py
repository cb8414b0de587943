"""WPaxos (lane-major sim kernel) and its seeded thin-read-quorum twin."""
