"""SwitchPaxos: Multi-Paxos through the in-fabric consensus tier
(``paxi_tpu_torch/switchnet``): switch-accepted commits and NOPaxos-style
ordered multicast, as a lane-major sim kernel (``sim.py``)."""
