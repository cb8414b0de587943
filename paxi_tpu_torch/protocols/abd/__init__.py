"""ABD atomic register (lane-major sim kernel)."""
