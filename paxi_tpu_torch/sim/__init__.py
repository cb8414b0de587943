"""The lock-step simulation runtime on torch."""

from paxi_tpu_torch.sim.types import (FAULT_FREE, FuzzConfig, SimConfig,
                                      SimProtocol, StepCtx)
from paxi_tpu_torch.sim.runner import SimResult, make_run, simulate

__all__ = ["SimConfig", "FuzzConfig", "FAULT_FREE", "SimProtocol",
           "StepCtx", "SimResult", "make_run", "simulate"]
