"""paxi_tpu_torch.obs — causal request tracing across the serving stack.

The observability triangle this package completes:

- **metrics** (metrics/registry.py) answer *how much / how often* —
  counters and histograms, aggregated, no causality;
- **spans** (here) answer *where one command's time went* — a causal
  tree per sampled command spanning router, entry node, leader quorum,
  executor and 2PC participants;
- **hunt witnesses** (hunt/) answer *what sequence of faults breaks
  it* — and replaying one on the virtual-clock fabric now emits a
  deterministic span timeline, so a divergence is a timeline diff.

See span.py for the taxonomy and wire contract, sample.py for the
head-sampling contract, collect.py for the write path, stitch.py for
the read path, render.py for output.
"""

from paxi_tpu_torch.obs.collect import SpanCollector
from paxi_tpu_torch.obs.render import ascii_timeline, chrome_trace
from paxi_tpu_torch.obs.sample import (Sampler, new_trace_id, process_sampler,
                                 sample_rate, set_sample_rate)
from paxi_tpu_torch.obs.span import (KINDS, SCHEMA, TRACE_HEADER, TRACE_PROP,
                               Span, TraceCtx, ctx_of, first_ctx,
                               validate_spans)
from paxi_tpu_torch.obs.stitch import (PHASES, aggregate_phases, by_trace,
                                 groups_of, label_group, merge, orphans,
                                 phases, stitched_traces, trees)

__all__ = [
    "KINDS", "PHASES", "SCHEMA", "TRACE_HEADER", "TRACE_PROP",
    "Sampler", "Span", "SpanCollector", "TraceCtx",
    "aggregate_phases", "ascii_timeline", "by_trace", "chrome_trace",
    "ctx_of", "first_ctx", "groups_of", "label_group", "merge",
    "new_trace_id", "orphans", "phases", "process_sampler",
    "sample_rate", "set_sample_rate", "stitched_traces", "trees",
    "validate_spans",
]
