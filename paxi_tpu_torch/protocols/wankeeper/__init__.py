"""WanKeeper (lane-major sim kernel)."""
