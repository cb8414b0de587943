"""Deterministic trace capture, replay and shrinking for the torch sim
runtime: ``capture`` records a violating group's fault schedule into a
versioned trace, ``replay`` reruns it bit for bit through the pinned
path, ``shrink`` delta-debugs it to a minimal witness.  The file format,
``state_hash`` and ``schedule_hash`` are the JAX package's, so a trace
moves between the two runtimes.
"""

from paxi_tpu_torch.trace.capture import capture
from paxi_tpu_torch.trace.format import (TRACE_VERSION, Trace, load,
                                         make_meta, save)
from paxi_tpu_torch.trace.replay import (ReplayResult, check_determinism,
                                         replay, state_hash)
from paxi_tpu_torch.trace.shrink import list_events, neutralize, shrink

__all__ = ["Trace", "TRACE_VERSION", "load", "save", "make_meta",
           "capture", "replay", "ReplayResult", "check_determinism",
           "state_hash", "shrink", "list_events", "neutralize"]
