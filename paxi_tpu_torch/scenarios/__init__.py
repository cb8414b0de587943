"""WAN topology, churn and reconfiguration scenarios for the torch sim
runtime and the host fabric: declarative ``Scenario`` specs (``spec.py``)
compiled onto the exchange's schedule planes (``schedule.py``) or onto the
virtual-clock fabric's fault surface (``compile.seq_schedule_of``), and
the named catalog (``compile.py``)."""

from paxi_tpu_torch.scenarios.spec import (LeaderChurn, Reconfig, Scenario,
                                           SwitchChurn, ZoneLatency,
                                           ZoneOutage, zone_of)
from paxi_tpu_torch.scenarios.compile import (NAMED, apply_switch, describe,
                                              latency_split, named_scenario,
                                              seq_schedule_of, with_scenario)

__all__ = ["Scenario", "ZoneLatency", "LeaderChurn", "Reconfig",
           "ZoneOutage", "SwitchChurn", "zone_of", "NAMED",
           "named_scenario", "describe", "latency_split", "seq_schedule_of",
           "with_scenario", "apply_switch"]
