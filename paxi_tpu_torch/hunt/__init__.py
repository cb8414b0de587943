"""Divergence-hunting campaigns on the torch sim runtime (the port's copy
of the JAX package's ``hunt/``).

``Campaign`` fuzzes the case matrix (``cases.py``) under a budget on the
card, captures each violating run as a trace, dedups it into a
persistent corpus, shrinks it, replays each minimal witness on the
asyncio host runtime through the virtual-clock fabric (on the CPU), and
classifies the outcome: ``reproduced`` (host bug candidate),
``diverged`` (sim modeling gap) or ``unmappable``.

CLI: ``python -m paxi_tpu_torch hunt run|status|report [--no-host]``.
"""

from paxi_tpu_torch.hunt.classify import (Classification, HostOutcome,
                                          OUTCOMES, classify,
                                          classify_witness, coverage_of,
                                          replay_schedule, replay_witness)
from paxi_tpu_torch.hunt.corpus import Corpus
from paxi_tpu_torch.hunt.engine import Campaign

__all__ = ["Campaign", "Corpus", "Classification", "HostOutcome",
           "OUTCOMES", "classify", "classify_witness", "coverage_of",
           "replay_schedule", "replay_witness"]
