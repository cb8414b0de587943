"""The in-fabric consensus tier, both halves: the sim's switch-acceptor
registers and ordered-multicast sequencer as lane-major carry planes
(``switchnet/plane.py``), which the ``switchpaxos`` kernel threads through
its state, and the host tier the virtual-clock fabric interposes on the
wire (``switchnet/switch.py``, ``SwitchTier``), which the switchpaxos host
twins speak through."""

from paxi_tpu_torch.switchnet import plane
from paxi_tpu_torch.switchnet.switch import (Sequencer, SwitchAcceptor,
                                             SwitchSnap, SwitchTier,
                                             SwitchVote)

__all__ = ["plane", "Sequencer", "SwitchAcceptor", "SwitchSnap",
           "SwitchTier", "SwitchVote"]
