"""Measurement for both runtimes: on-device commit-latency histograms and
run counters (``lathist``, ``simcount``), and the host runtime's
registry of labeled counters, gauges and fixed-bucket histograms
(``registry``, standard library only)."""

from paxi_tpu_torch.metrics.registry import (HIST_BOUNDS, Counter, Gauge,
                                             Histogram, Registry,
                                             merge_snapshots,
                                             parse_prometheus, pretty,
                                             render_prometheus)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "HIST_BOUNDS",
           "merge_snapshots", "parse_prometheus", "pretty",
           "render_prometheus"]
