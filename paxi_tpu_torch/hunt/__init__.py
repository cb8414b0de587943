"""Divergence-hunting campaigns on the torch sim runtime (the port's copy
of the JAX package's ``hunt/``, host replay left out).

``Campaign`` fuzzes the case matrix (``cases.py``) under a budget,
captures each violating run as a trace, dedups it into a persistent
corpus, shrinks it, and classifies it by projection coverage.  The host
replay that tells ``reproduced`` from ``diverged`` runs on the asyncio
host runtime, which stays in the JAX package
(``python -m paxi_tpu hunt run --traces-dir <port corpus>``).

CLI: ``python -m paxi_tpu_torch hunt run|status|report --no-host``.
"""

from paxi_tpu_torch.hunt.classify import (Classification, HostOutcome,
                                          OUTCOMES, classify,
                                          classify_witness, coverage_of)
from paxi_tpu_torch.hunt.corpus import Corpus
from paxi_tpu_torch.hunt.engine import Campaign

__all__ = ["Campaign", "Corpus", "Classification", "HostOutcome",
           "OUTCOMES", "classify", "classify_witness", "coverage_of"]
