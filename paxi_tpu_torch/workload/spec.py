"""The declarative workload vocabulary: key popularity, read mixes and
arrival bursts as data (the port's copy of the JAX package's
``workload/spec.py``, with the same fields, defaults and JSON form, so a
trace's ``sim_cfg`` meta means the same run in both packages).

A ``Workload`` describes the traffic a protocol serves:

- **distribution**: which keys the offered commands touch — uniform,
  Zipf(theta) (rank r drawn with weight 1/(r+1)^theta), or an explicit
  hot set (``hot_keys`` keys taking ``hot_weight`` of the draws);
- **read mix**: ``read_frac`` of commands are reads (no state mutation);
- **flash crowd**: timed arrival surges; in the sim the proposer's demand
  gate runs a ``1/mult`` duty cycle outside the windows, so a surge
  offers ``mult`` times the demand;
- **hot-key migration**: ``migrate_every`` rotates which key ids are
  popular every N steps (popularity ranks stay; the rank -> key mapping
  shifts).

Draws are counter-based (``workload/compile.py``): every sample is an
integer hash of (spec seed, global group id, step or slot, channel), so
the same spec lowers bit for bit onto the lane-major kernels, the
per-group kernel and a sharded run.  Every class here is a frozen
dataclass of ints and floats: hashable (a Workload rides inside
``SimConfig``) and serialisable with ``dataclasses.asdict``; ``from_dict``
rebuilds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

# key-class label order: class id 0/1/2 = hot/warm/cold everywhere
CLASSES = ("hot", "warm", "cold")


@dataclass(frozen=True)
class FlashCrowd:
    """Arrival surges: windows ``[start + k*period, .. + duration)``
    (``period=0``: a single window), in sim steps."""

    start: int = 20
    period: int = 0       # steps between window starts (0: one-shot)
    duration: int = 10    # steps each surge lasts
    mult: float = 4.0     # arrival-rate multiplier during a surge
    focus: float = 0.0    # extra P(draw lands on the hot ranks) in a surge
    # (read by the host generators only)


@dataclass(frozen=True)
class Workload:
    """A key-popularity / read-mix / burst workload (module docstring).

    ``hot_cut``/``warm_cut`` split popularity ranks into the hot/warm/cold
    classes whose latency is reported apart: ranks below
    ``ceil(hot_cut*K)`` are hot, below ``ceil(warm_cut*K)`` warm, the rest
    cold (``dist="hotset"`` makes the explicit ``hot_keys`` the hot
    class)."""

    name: str = "workload"
    dist: str = "uniform"      # uniform | zipf | hotset
    theta: float = 0.99        # zipf: P(rank r) ~ 1/(r+1)^theta
    hot_keys: int = 4          # hotset: size of the hot set
    hot_weight: float = 0.9    # hotset: P(draw lands in the hot set)
    read_frac: float = 0.0     # fraction of commands that are reads
    flash: Optional[FlashCrowd] = None
    migrate_every: int = 0     # rotate the hot key ids every N steps
    hot_cut: float = 0.05      # class split: top ranks -> "hot"
    warm_cut: float = 0.30     # next ranks -> "warm"; rest "cold"
    seed: int = 0              # spec-level salt folded into every draw

    def validate(self, n_keys: int) -> "Workload":
        """Raise ValueError on an inconsistent spec; returns self."""
        if n_keys < 1:
            raise ValueError(f"workload {self.name!r}: n_keys must be "
                             f">= 1, got {n_keys}")
        if self.dist not in ("uniform", "zipf", "hotset"):
            raise ValueError(f"workload {self.name!r}: unknown dist "
                             f"{self.dist!r}")
        if self.dist == "zipf" and self.theta <= 0:
            raise ValueError(f"workload {self.name!r}: zipf theta must "
                             f"be > 0, got {self.theta}")
        if self.dist == "hotset":
            if not 1 <= self.hot_keys <= n_keys:
                raise ValueError(
                    f"workload {self.name!r}: hot_keys={self.hot_keys} "
                    f"outside 1..{n_keys}")
            if not 0.0 < self.hot_weight <= 1.0:
                raise ValueError(f"workload {self.name!r}: hot_weight "
                                 "must be in (0, 1]")
        if not 0.0 <= self.read_frac <= 1.0:
            raise ValueError(f"workload {self.name!r}: read_frac must "
                             "be in [0, 1]")
        if not 0.0 < self.hot_cut <= self.warm_cut <= 1.0:
            raise ValueError(f"workload {self.name!r}: need 0 < hot_cut"
                             f"={self.hot_cut} <= warm_cut="
                             f"{self.warm_cut} <= 1")
        if self.migrate_every < 0:
            raise ValueError(f"workload {self.name!r}: migrate_every "
                             "must be >= 0")
        if self.flash is not None:
            fl = self.flash
            if fl.start < 0 or fl.duration < 1 or fl.period < 0:
                raise ValueError(f"workload {self.name!r}: flash needs "
                                 "start >= 0, duration >= 1 and "
                                 "period >= 0")
            if fl.period and fl.duration > fl.period:
                raise ValueError(f"workload {self.name!r}: flash "
                                 f"duration={fl.duration} must be <= "
                                 f"period={fl.period}")
            if fl.mult < 1.0:
                raise ValueError(f"workload {self.name!r}: flash mult "
                                 "must be >= 1")
            if not 0.0 <= fl.focus <= 1.0:
                raise ValueError(f"workload {self.name!r}: flash focus "
                                 "must be in [0, 1]")
        return self

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Workload":
        """Rebuild from ``dataclasses.asdict`` output after a JSON round
        trip (trace meta)."""
        fl = d.get("flash")
        flash = FlashCrowd(start=int(fl["start"]),
                           period=int(fl.get("period", 0)),
                           duration=int(fl.get("duration", 1)),
                           mult=float(fl.get("mult", 1.0)),
                           focus=float(fl.get("focus", 0.0))) \
            if fl else None
        return Workload(name=str(d.get("name", "workload")),
                        dist=str(d.get("dist", "uniform")),
                        theta=float(d.get("theta", 0.99)),
                        hot_keys=int(d.get("hot_keys", 4)),
                        hot_weight=float(d.get("hot_weight", 0.9)),
                        read_frac=float(d.get("read_frac", 0.0)),
                        flash=flash,
                        migrate_every=int(d.get("migrate_every", 0)),
                        hot_cut=float(d.get("hot_cut", 0.05)),
                        warm_cut=float(d.get("warm_cut", 0.30)),
                        seed=int(d.get("seed", 0)))
