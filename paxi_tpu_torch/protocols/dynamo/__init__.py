"""Dynamo-style eventual store (lane-major sim kernel)."""
