"""Workload engine for the torch sim runtime: key-popularity skew, read
mixes and flash crowds as data (the port's copy of the JAX package's
``paxi_tpu/workload``, sim half).

Declarative ``Workload`` specs (``spec.py``) lower onto the sim kernels'
command paths from counter-based draws (``compile.py``): per-step key,
read and class planes from (spec seed, global group id, absolute slot)
hashes, identical across the lane-major, per-group and sharded lowerings
and under pinned replay.  Key classes (hot/warm/cold) label per-class
latency histograms (``class_split``).
"""

from paxi_tpu_torch.workload.spec import CLASSES, FlashCrowd, Workload
from paxi_tpu_torch.workload.compile import (FLASH, HOTRANGE, MIGRATE,
                                             NAMED, UNIFORM, ZIPF99,
                                             apply_workload, class_cuts,
                                             class_plane, class_split,
                                             demand_gate, describe,
                                             flash_on, host_sampler,
                                             icdf_table, key_plane,
                                             named_workload,
                                             rank_plane, rank_pmf,
                                             read_plane)

__all__ = ["Workload", "FlashCrowd", "CLASSES", "NAMED", "UNIFORM",
           "ZIPF99", "FLASH", "HOTRANGE", "MIGRATE",
           "named_workload", "describe", "apply_workload", "class_cuts",
           "icdf_table", "rank_pmf", "key_plane", "rank_plane",
           "read_plane", "class_plane", "flash_on", "demand_gate",
           "class_split", "host_sampler"]
