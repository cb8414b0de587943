"""Longest-chain blockchain (lane-major sim kernel)."""
