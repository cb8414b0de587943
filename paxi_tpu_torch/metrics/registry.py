"""Host-side metrics model: counters and mergeable latency histograms
(the port's copy of the JAX package's ``metrics/registry.py``).

Standard library only (the host runtime imports no torch), and ONE fixed
bucket layout for every histogram: log-spaced bounds, 6 buckets a
decade from 1 µs to 1000 s, plus an overflow bucket.  A shared layout
is what makes merging exact: adding two histograms' bucket-count
vectors is the histogram of the union of their samples, so per-stream
and per-node series aggregate without approximation, and a sim
histogram converted by ``lathist.to_host_snapshot`` merges with the
host runtime's snapshots (the snapshot carries the scheme's name).

Percentiles are derived from buckets by nearest rank: the answer is the
geometric midpoint of the bucket holding the rank, exact to within one
bucket's width (~±21% at 6 buckets a decade).
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

# 6 log-spaced buckets per decade, 1 µs .. 1000 s (54 bounds), plus a
# +Inf overflow bucket.  Changing this breaks snapshot mergeability —
# from_snapshot()/merge_snapshots() check the stamped scheme version.
HIST_SCHEME = "log6:1e-6:54"
HIST_BOUNDS: Tuple[float, ...] = tuple(
    1e-6 * 10.0 ** ((i + 1) / 6.0) for i in range(54))
_N = len(HIST_BOUNDS)


class Counter:
    """A monotonically increasing integer."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A settable instantaneous level (queue depth, in-flight count).

    Merge semantics across nodes is SUM: the fleet-level depth is the
    sum of per-node depths, the same way Prometheus users sum gauge
    series — a last-writer-wins merge would be meaningless for
    scrape-skewed snapshots."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket log-spaced histogram; merge is exact (see module
    docstring).  Tracks exact sum/min/max alongside bucket counts."""

    __slots__ = ("counts", "count", "sum", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts = [0] * (_N + 1)   # [..buckets.., overflow]
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @property
    def min(self) -> float:
        return self.vmin if self.count else 0.0

    @property
    def max(self) -> float:
        return self.vmax if self.count else 0.0

    def observe(self, v: float) -> None:
        self.counts[min(bisect.bisect_left(HIST_BOUNDS, v), _N)] += 1
        self.count += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "Histogram") -> "Histogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile from buckets, clamped to the exact
        observed [min, max] envelope."""
        if not self.count:
            return 0.0
        rank = max(math.ceil(p / 100.0 * self.count), 1)
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                if i >= _N:             # overflow bucket
                    return self.vmax
                lo = HIST_BOUNDS[i - 1] if i else HIST_BOUNDS[0] / 10 ** (1 / 6)
                mid = math.sqrt(lo * HIST_BOUNDS[i])
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    # ---- snapshot (the JSON schema README documents) -------------------
    def to_snapshot(self) -> Dict[str, Any]:
        return {
            "scheme": HIST_SCHEME,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            # sparse: bucket index -> count (index _N is overflow)
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "Histogram":
        if snap.get("scheme") != HIST_SCHEME:
            raise ValueError(
                f"histogram scheme {snap.get('scheme')!r} incompatible "
                f"with {HIST_SCHEME!r}")
        h = cls()
        for i, c in snap["buckets"].items():
            h.counts[int(i)] = int(c)
        h.count = int(snap["count"])
        h.sum = float(snap["sum"])
        if h.count:
            h.vmin = float(snap["min"])
            h.vmax = float(snap["max"])
        return h


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Registry:
    """Get-or-create store of labeled counters and histograms.

    ``Registry(node="1.1")`` stamps every exported series with the
    constant labels; per-series labels come from the call site
    (``reg.counter("paxi_msgs_in_total", type="P2a")``)."""

    def __init__(self, **labels: str) -> None:
        self.labels = {k: str(v) for k, v in labels.items()}
        self._counters: Dict[Tuple[str, tuple], Counter] = {}
        self._hists: Dict[Tuple[str, tuple], Histogram] = {}
        self._gauges: Dict[Tuple[str, tuple], Gauge] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        return h

    # ---- export --------------------------------------------------------
    def _full_labels(self, lk: tuple) -> Dict[str, str]:
        return {**self.labels, **dict(lk)}

    def snapshot(self) -> Dict[str, Any]:
        """The JSON form (``GET /metrics?format=json``)."""
        return {
            "counters": [
                {"name": n, "labels": self._full_labels(lk),
                 "value": c.value}
                for (n, lk), c in self._counters.items()],
            "gauges": [
                {"name": n, "labels": self._full_labels(lk),
                 "value": g.value}
                for (n, lk), g in self._gauges.items()],
            "histograms": [
                {"name": n, "labels": self._full_labels(lk),
                 **h.to_snapshot()}
                for (n, lk), h in self._hists.items()],
        }

    def prometheus(self) -> str:
        return render_prometheus(self.snapshot())


# ---- snapshot-level operations (merge / render / parse) -----------------
def merge_snapshots(snaps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate snapshots: counters with identical (name, labels) add;
    histograms bucket-merge exactly (shared bounds)."""
    counters: Dict[Tuple[str, tuple], int] = {}
    gauges: Dict[Tuple[str, tuple], float] = {}
    hists: Dict[Tuple[str, tuple], Histogram] = {}
    labels: Dict[Tuple[str, tuple], Dict[str, str]] = {}
    for snap in snaps:
        for c in snap.get("counters", []):
            key = (c["name"], _label_key(c.get("labels", {})))
            counters[key] = counters.get(key, 0) + int(c["value"])
            labels[key] = dict(c.get("labels", {}))
        for g in snap.get("gauges", []):
            key = (g["name"], _label_key(g.get("labels", {})))
            gauges[key] = gauges.get(key, 0.0) + float(g["value"])
            labels[key] = dict(g.get("labels", {}))
        for hs in snap.get("histograms", []):
            key = (hs["name"], _label_key(hs.get("labels", {})))
            h = Histogram.from_snapshot(hs)
            if key in hists:
                hists[key].merge(h)
            else:
                hists[key] = h
            labels[key] = dict(hs.get("labels", {}))
    return {
        "counters": [{"name": n, "labels": labels[(n, lk)], "value": v}
                     for (n, lk), v in counters.items()],
        "gauges": [{"name": n, "labels": labels[(n, lk)], "value": v}
                   for (n, lk), v in gauges.items()],
        "histograms": [{"name": n, "labels": labels[(n, lk)],
                        **h.to_snapshot()}
                       for (n, lk), h in hists.items()],
    }


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(snap: Dict[str, Any]) -> str:
    """Prometheus text exposition (v0.0.4) of a snapshot."""
    out: List[str] = []
    seen_type: set = set()
    for c in snap.get("counters", []):
        if c["name"] not in seen_type:
            out.append(f"# TYPE {c['name']} counter")
            seen_type.add(c["name"])
        out.append(f"{c['name']}{_fmt_labels(c['labels'])} {c['value']}")
    for g in snap.get("gauges", []):
        if g["name"] not in seen_type:
            out.append(f"# TYPE {g['name']} gauge")
            seen_type.add(g["name"])
        out.append(f"{g['name']}{_fmt_labels(g['labels'])} "
                   f"{g['value']:.9g}")
    for hs in snap.get("histograms", []):
        name = hs["name"]
        if name not in seen_type:
            out.append(f"# TYPE {name} histogram")
            seen_type.add(name)
        labels = hs.get("labels", {})
        counts = [0] * (_N + 1)
        for i, c in hs["buckets"].items():
            counts[int(i)] = int(c)
        acc = 0
        for i, c in enumerate(counts[:_N]):
            acc += c
            if c:  # sparse text: only buckets that gained samples
                le = _fmt_labels({**labels, "le": f"{HIST_BOUNDS[i]:.3e}"})
                out.append(f"{name}_bucket{le} {acc}")
        le = _fmt_labels({**labels, "le": "+Inf"})
        out.append(f"{name}_bucket{le} {hs['count']}")
        out.append(f"{name}_sum{_fmt_labels(labels)} {hs['sum']:.9g}")
        out.append(f"{name}_count{_fmt_labels(labels)} {hs['count']}")
    return "\n".join(out) + ("\n" if out else "")


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse exposition text back to (name, labels, value) samples —
    the scrape-side half the smoke test and the CLI lean on."""
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        labels: Dict[str, str] = {}
        name = head
        if head.endswith("}"):
            name, _, rest = head.partition("{")
            for part in rest[:-1].split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        samples.append((name, labels, float(val)))
    return samples


def pretty(snap: Dict[str, Any]) -> str:
    """Human-readable rendering of a snapshot (the CLI's output)."""
    lines: List[str] = []
    counters = sorted(snap.get("counters", []),
                      key=lambda c: (c["name"], sorted(c["labels"].items())))
    if counters:
        lines.append("counters:")
        width = max(len(c["name"] + _fmt_labels(c["labels"]))
                    for c in counters)
        for c in counters:
            tag = c["name"] + _fmt_labels(c["labels"])
            lines.append(f"  {tag:<{width}}  {c['value']}")
    gauges = sorted(snap.get("gauges", []),
                    key=lambda g: (g["name"], sorted(g["labels"].items())))
    if gauges:
        lines.append("gauges:")
        width = max(len(g["name"] + _fmt_labels(g["labels"]))
                    for g in gauges)
        for g in gauges:
            tag = g["name"] + _fmt_labels(g["labels"])
            lines.append(f"  {tag:<{width}}  {g['value']:g}")
    hists = sorted(snap.get("histograms", []),
                   key=lambda h: (h["name"], sorted(h["labels"].items())))
    if hists:
        lines.append("histograms:")
        for hs in hists:
            h = Histogram.from_snapshot(hs)
            tag = hs["name"] + _fmt_labels(hs["labels"])
            lines.append(
                f"  {tag}: count={h.count} mean={h.mean() * 1e3:.3f}ms "
                f"p50={h.percentile(50) * 1e3:.3f}ms "
                f"p95={h.percentile(95) * 1e3:.3f}ms "
                f"p99={h.percentile(99) * 1e3:.3f}ms "
                f"p999={h.percentile(99.9) * 1e3:.3f}ms "
                f"max={h.max * 1e3:.3f}ms")
    return "\n".join(lines) if lines else "(empty)"
