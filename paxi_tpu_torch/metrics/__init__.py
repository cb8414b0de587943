"""On-device measurement: commit-latency histograms and run counters."""
