"""The in-fabric consensus tier's sim half: switch-acceptor registers and
the ordered-multicast sequencer as lane-major carry planes
(``switchnet/plane.py``), which the ``switchpaxos`` kernel threads through
its state.  The host tier of the JAX package (``switchnet/switch.py``) is
an asyncio layer and has no counterpart here."""

from paxi_tpu_torch.switchnet import plane

__all__ = ["plane"]
