"""Head-based sampling — decided once, at the entry point.

The sampling contract: the *first* tier a command enters (RouterServer
in sharded serving, the node HTTP server otherwise) consults its
sampler exactly once; everything downstream keys off the presence of
the propagated trace context and never re-samples.  A command without
a ``trace`` property is unsampled and pays only one dict lookup per
instrumentation site.

The sampler is a deterministic *accumulator*, not a coin flip: at rate
``r`` it admits every ``round(1/r)``-th decision with no RNG state, so
a replayed workload samples the same commands every run — the property
the fabric-deterministic timeline tests rely on.  The process-wide rate
comes from ``PAXI_TRACE_SAMPLE`` (0..1, default 0 = tracing off) and can
be set programmatically by benches.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional


class Sampler:
    __slots__ = ("rate", "_acc")

    def __init__(self, rate: float = 0.0):
        self.rate = max(0.0, min(1.0, float(rate)))
        self._acc = 0.0

    def decide(self) -> bool:
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        self._acc += self.rate
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    def reset(self) -> None:
        self._acc = 0.0


def _env_rate() -> float:
    try:
        return float(os.environ.get("PAXI_TRACE_SAMPLE", "") or 0.0)
    except ValueError:
        return 0.0


_PROCESS = Sampler(_env_rate())
_TRACE_SEQ = itertools.count(1)


def process_sampler() -> Sampler:
    return _PROCESS


def set_sample_rate(rate: float) -> None:
    """Benches and the verify smoke flip the process rate directly;
    servers inherit it via PAXI_TRACE_SAMPLE in their environment."""
    _PROCESS.rate = max(0.0, min(1.0, float(rate)))
    _PROCESS.reset()


def sample_rate() -> float:
    return _PROCESS.rate


def new_trace_id(salt: Optional[str] = None) -> str:
    """A process-unique trace id for a freshly sampled command.  The
    per-process counter keeps ids deterministic under one entry
    process; multi-process deployments disambiguate via the pid salt.
    Fabric replays do not mint ids here — they inject fixed ids with
    the workload, which is what makes two replays byte-identical."""
    n = next(_TRACE_SEQ)
    return f"t{salt or format(os.getpid(), 'x')}-{n}"
