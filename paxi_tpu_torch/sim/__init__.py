"""The lock-step simulation runtime on torch."""

from paxi_tpu_torch.sim.types import (FAULT_FREE, FuzzConfig, SimConfig,
                                      SimProtocol, StepCtx)
from paxi_tpu_torch.sim.runner import (SimResult, continue_run,
                                       make_pinned_run, make_recorded_run,
                                       make_run, simulate)
from paxi_tpu_torch.sim.checkpoint import load_carry, save_carry

__all__ = ["SimConfig", "FuzzConfig", "FAULT_FREE", "SimProtocol",
           "StepCtx", "SimResult", "make_run", "simulate",
           "continue_run", "make_recorded_run", "make_pinned_run",
           "save_carry", "load_carry"]
