"""Fixed-bucket log-spaced latency histograms: constant memory, exact
counts, mergeable by bucket-wise addition.

The port's copy of ``repro.obs.histogram``: the same bucket bounds and
the same ``state()`` JSON, so histograms of either package merge exactly.

Why not the old bounded-deque reservoir: a reservoir's percentiles are
exact only for the one stream it sampled — two reservoirs cannot be
combined into the percentiles of the union (which observations fell
out of each window is unrecoverable), so per-stage, per-model, and
per-replica latency could never be aggregated honestly.  A fixed-bucket
histogram keeps one int per bucket forever, counts every observation
exactly, and merging is integer addition — the aggregate over any set
of models/replicas has the same fidelity as a single instance.

Bucket scheme: upper edges at ``lo * growth**i`` covering 1 µs .. 64 s
with 16 buckets per decade (growth 10^(1/16) ≈ 1.155, so any
interpolated percentile is within ~±8 % of the true value before
interpolation even helps), plus one overflow bucket.  ~126 buckets
total — about 1 KiB per histogram.  Percentile estimates interpolate
linearly inside the winning bucket and are clamped to the exact
observed [min, max], so a histogram never reports a latency outside
what was actually seen.
"""

from __future__ import annotations

import bisect
import math
import threading


def log_bounds(
    lo: float = 1e-6, hi: float = 64.0, per_decade: int = 16
) -> tuple[float, ...]:
    """Log-spaced bucket upper edges (seconds), ``lo`` .. ≥ ``hi``."""
    if not (0 < lo < hi) or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} per_decade={per_decade}")
    n = math.ceil(per_decade * math.log10(hi / lo))
    growth = 10.0 ** (1.0 / per_decade)
    return tuple(lo * growth**i for i in range(n + 1))


_DEFAULT_BOUNDS = log_bounds()


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram over non-negative seconds."""

    __slots__ = ("_bounds", "_counts", "_count", "_sum", "_min", "_max",
                 "_exemplars", "_lock")

    def __init__(self, bounds: tuple[float, ...] | None = None):
        bounds = _DEFAULT_BOUNDS if bounds is None else tuple(float(b) for b in bounds)
        if len(bounds) < 2 or any(a >= b for a, b in zip(bounds, bounds[1:])):
            raise ValueError("bounds must be at least two strictly increasing edges")
        self._bounds = bounds
        # counts[i] holds observations v with bounds[i-1] < v <= bounds[i]
        # (Prometheus `le` semantics); counts[-1] is the +Inf overflow
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min: float | None = None
        self._max: float | None = None
        # bucket index -> id of the last observation that landed there
        # (an exemplar: links a tail bucket to a concrete request trace)
        self._exemplars: dict[int, str] = {}
        self._lock = threading.Lock()

    # -- writes ------------------------------------------------------------

    def observe(self, seconds: float, exemplar: str | None = None) -> None:
        v = max(0.0, float(seconds))
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[i] = str(exemplar)

    # -- wire state (the fleet-aggregator scrape format) -------------------

    def state(self) -> dict:
        """Full-fidelity plain-JSON state: bounds, per-bucket counts,
        exact sum, observed min/max, and exemplars.  Unlike
        :meth:`snapshot` (percentile estimates for humans), this is the
        *scrape* format — ``from_state(h.state())`` reconstructs a
        histogram whose merge behavior is bit-identical to the original,
        so a fleet aggregator can sum buckets across processes instead
        of averaging percentiles."""
        with self._lock:
            return {
                "bounds": list(self._bounds),
                "counts": list(self._counts),
                "count": int(self._count),
                "sum_s": float(self._sum),
                "min_s": self._min,
                "max_s": self._max,
                # JSON objects key by string; from_state converts back
                "exemplars": {str(i): e for i, e in self._exemplars.items()},
            }

    @classmethod
    def from_state(cls, state: dict) -> "LatencyHistogram":
        """Exact inverse of :meth:`state`; loud on malformed input."""
        try:
            bounds = tuple(float(b) for b in state["bounds"])
            counts = [int(c) for c in state["counts"]]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed histogram state: {e}") from None
        out = cls(bounds)
        if len(counts) != len(out._counts):
            raise ValueError(
                f"histogram state has {len(counts)} counts for "
                f"{len(bounds)} bounds (want {len(out._counts)})"
            )
        if any(c < 0 for c in counts):
            raise ValueError("histogram state has negative bucket counts")
        total = int(state["count"])
        if total != sum(counts):
            raise ValueError(
                f"histogram state count {total} != bucket sum {sum(counts)}"
            )
        out._counts = counts
        out._count = total
        out._sum = float(state["sum_s"])
        out._min = None if state.get("min_s") is None else float(state["min_s"])
        out._max = None if state.get("max_s") is None else float(state["max_s"])
        out._exemplars = {
            int(i): str(e) for i, e in (state.get("exemplars") or {}).items()
        }
        return out

    # -- merge -------------------------------------------------------------

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Bucket-wise sum of two histograms (same bounds) as a new one.

        Exact: ``h1.merge(h2).percentile(p)`` equals the percentile of
        one histogram fed both observation streams.
        """
        if self._bounds != other._bounds:
            raise ValueError("cannot merge histograms with different bucket bounds")
        out = LatencyHistogram(self._bounds)
        with self._lock:
            a = (list(self._counts), self._count, self._sum, self._min, self._max,
                 dict(self._exemplars))
        with other._lock:
            b = (list(other._counts), other._count, other._sum, other._min,
                 other._max, dict(other._exemplars))
        out._counts = [x + y for x, y in zip(a[0], b[0])]
        out._count = a[1] + b[1]
        out._sum = a[2] + b[2]
        mins = [m for m in (a[3], b[3]) if m is not None]
        maxs = [m for m in (a[4], b[4]) if m is not None]
        out._min = min(mins) if mins else None
        out._max = max(maxs) if maxs else None
        # either stream's exemplar is a valid representative of the
        # merged bucket; `other` wins ties (it is "the newer stream" in
        # the fleet-merge call pattern pool.merge(replica))
        out._exemplars = {**a[5], **b[5]}
        return out

    # -- reads -------------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum_s(self) -> float:
        with self._lock:
            return self._sum

    def bucket_bounds(self) -> tuple[float, ...]:
        return self._bounds

    def bucket_counts(self) -> list[int]:
        with self._lock:
            return list(self._counts)

    def cumulative(self) -> list[tuple[float, int]]:
        """(upper_edge, cumulative_count) pairs ending with (inf, count)
        — exactly the Prometheus ``le`` bucket series."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for bound, c in zip(self._bounds, counts):
            cum += c
            out.append((bound, cum))
        out.append((math.inf, cum + counts[-1]))
        return out

    def count_over(self, threshold_s: float) -> int:
        """Exact count of observations recorded above the smallest bucket
        edge >= ``threshold_s`` — the SLO-burn numerator.  Counting is
        bucket-granular: an objective aligned to a bucket edge is exact;
        one inside a bucket rounds up to that bucket's upper edge (so the
        reported burn never exaggerates)."""
        i = bisect.bisect_left(self._bounds, max(0.0, float(threshold_s)))
        with self._lock:
            return sum(self._counts[i + 1 :]) if i < len(self._bounds) else 0

    def percentile(self, p: float) -> float | None:
        """Estimated p-th percentile in seconds (None when empty).

        Linear interpolation inside the winning bucket, clamped to the
        exact observed [min, max].
        """
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            counts = list(self._counts)
            count, vmin, vmax = self._count, self._min, self._max
        if count == 0:
            return None
        target = min(max(math.ceil(p / 100.0 * count), 1), count)
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i] if i < len(self._bounds) else vmax
                val = lo + (target - cum) / c * (hi - lo)
                return min(max(val, vmin), vmax)
            cum += c
        return vmax  # unreachable unless counts raced; max is always safe

    def percentiles_ms(
        self, ps: tuple[float, ...] = (50.0, 90.0, 99.0)
    ) -> dict[str, float | None]:
        out = {}
        for p in ps:
            v = self.percentile(p)
            out[f"p{p:g}_ms"] = None if v is None else v * 1e3
        return out

    def tail_exemplars(self, p: float = 99.0, limit: int = 8) -> list[dict]:
        """Exemplar ids of the tail: one entry per non-empty bucket at or
        above the p-th-percentile bucket that has recorded an exemplar,
        hottest last.  Each entry links a latency band to a concrete
        request trace (`/v1/traces?id=`): ``{"le_ms": upper edge (None =
        overflow), "count": bucket count, "trace_id": exemplar}``.
        """
        with self._lock:
            counts = list(self._counts)
            count = self._count
            exemplars = dict(self._exemplars)
        if count == 0 or not exemplars:
            return []
        target = min(max(math.ceil(p / 100.0 * count), 1), count)
        cum, start = 0, len(counts) - 1
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                start = i
                break
        out = []
        for i in range(start, len(counts)):
            if counts[i] and i in exemplars:
                le = self._bounds[i] * 1e3 if i < len(self._bounds) else None
                out.append(
                    {"le_ms": le, "count": int(counts[i]), "trace_id": exemplars[i]}
                )
        return out[-limit:]

    def snapshot(self) -> dict:
        """Plain-JSON summary: exact count/total/mean, estimated
        percentiles; absent values are None, never NaN."""
        with self._lock:
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        out = {
            "count": int(count),
            "total_ms": float(total * 1e3),
            "mean_ms": (total / count * 1e3) if count else None,
            "min_ms": None if vmin is None else vmin * 1e3,
            "max_ms": None if vmax is None else vmax * 1e3,
        }
        out.update(self.percentiles_ms())
        tail = self.tail_exemplars()
        if tail:
            out["tail_exemplars"] = tail
        return out
