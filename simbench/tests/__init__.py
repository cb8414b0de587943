"""Tests of the benchmark (CPU; the card's own under the gpu marker)."""
