"""Windowed time series over cumulative counter snapshots.

The port's copy of ``repro.obs.window`` (stdlib only).

The histograms and counters in `repro_torch.obs` are cumulative by design —
exact, mergeable, restart-free.  What they cannot answer alone is
*"what is happening right now"*: request rate, shed rate, whether the
queue is growing or draining, how much of the last minute violated the
latency objective.  `MetricsWindow` closes that gap the only honest
way: it keeps a bounded window of timestamped **cumulative** snapshots
and derives every rate from **deltas between snapshots** — never by
averaging percentiles or rates (the mean of two rates over unequal
intervals is not the rate of the union).

Exactness at the eviction boundary: because every retained snapshot is
cumulative, the window-wide rate is ``(last - first) / (t_last -
t_first)`` over whatever snapshots survive — evicting old snapshots
shortens the window but never corrupts the rates inside it.  A
windowed *sum* of per-interval deltas would silently lose the evicted
intervals; the first-to-last delta cannot.

One `MetricsWindow` per (model) at the aggregator; `append` is called
once per scrape with the fleet-merged cumulative values, `series()`
is read by ``GET /v1/fleet`` and the Prometheus exposition.
"""

from __future__ import annotations

import collections
import threading


class WindowSnapshot:
    """One timestamped cumulative observation (immutable)."""

    __slots__ = ("t", "n_requests", "n_shed", "queue_depth", "n_observed",
                 "n_over_slo")

    def __init__(
        self,
        t: float,
        *,
        n_requests: int,
        n_shed: int,
        queue_depth: int,
        n_observed: int = 0,
        n_over_slo: int = 0,
    ):
        self.t = float(t)
        self.n_requests = int(n_requests)   # cumulative requests completed
        self.n_shed = int(n_shed)           # cumulative requests shed
        self.queue_depth = int(queue_depth)  # gauge: queued right now
        self.n_observed = int(n_observed)   # cumulative latency observations
        self.n_over_slo = int(n_over_slo)   # cumulative observations > SLO


class MetricsWindow:
    """Bounded window of cumulative snapshots -> exact derived series."""

    def __init__(self, capacity: int = 256):
        if capacity < 2:
            raise ValueError(f"window needs >= 2 snapshots, got {capacity}")
        self.capacity = int(capacity)
        self._snaps: collections.deque[WindowSnapshot] = collections.deque(
            maxlen=capacity
        )
        self._lock = threading.Lock()
        self.n_appended = 0  # total ever appended (eviction visibility)

    def append(self, snap: WindowSnapshot) -> None:
        """Add one scrape's cumulative values.  Out-of-order or repeated
        timestamps are refused loudly — a window whose time axis is not
        strictly increasing derives garbage rates."""
        with self._lock:
            if self._snaps and snap.t <= self._snaps[-1].t:
                raise ValueError(
                    f"snapshot at t={snap.t} is not after the window's "
                    f"latest t={self._snaps[-1].t}"
                )
            self._snaps.append(snap)
            self.n_appended += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)

    @property
    def span_s(self) -> float:
        """Seconds covered by the retained window (0 until 2 snapshots)."""
        with self._lock:
            if len(self._snaps) < 2:
                return 0.0
            return self._snaps[-1].t - self._snaps[0].t

    # -- derived series ----------------------------------------------------

    def series(self) -> dict:
        """Exact derived view over the retained window (strict JSON).

        Rates come from the first-to-last cumulative delta; the
        ``queue_depth`` trajectory is the per-snapshot gauge readings
        with a least-squares slope (`queue_depth_dps`, requests/s —
        positive means the fleet is falling behind); `slo_burn` is the
        fraction of window observations over the latency objective.
        All keys are present with None when underivable (single
        snapshot, zero traffic) — never NaN.
        """
        with self._lock:
            snaps = list(self._snaps)
        out = {
            "n_snapshots": len(snaps),
            "span_s": None,
            "request_rate_rps": None,
            "shed_rate_rps": None,
            "shed_fraction": None,
            "queue_depth": snaps[-1].queue_depth if snaps else None,
            "queue_depth_series": [
                [s.t - snaps[0].t, s.queue_depth] for s in snaps
            ] if snaps else [],
            "queue_depth_dps": None,
            "slo_burn": None,
        }
        if len(snaps) < 2:
            return out
        first, last = snaps[0], snaps[-1]
        dt = last.t - first.t
        d_req = last.n_requests - first.n_requests
        d_shed = last.n_shed - first.n_shed
        out["span_s"] = dt
        out["request_rate_rps"] = d_req / dt
        out["shed_rate_rps"] = d_shed / dt
        offered = d_req + d_shed
        if offered > 0:
            out["shed_fraction"] = d_shed / offered
        d_obs = last.n_observed - first.n_observed
        if d_obs > 0:
            out["slo_burn"] = (last.n_over_slo - first.n_over_slo) / d_obs
        out["queue_depth_dps"] = self._slope(snaps)
        return out

    @staticmethod
    def _slope(snaps: list[WindowSnapshot]) -> float:
        """Least-squares slope of queue depth over time (depth/s): more
        robust than a two-point difference when scrape intervals jitter
        and depth oscillates with the batch cadence."""
        n = len(snaps)
        t0 = snaps[0].t
        mean_t = sum(s.t - t0 for s in snaps) / n
        mean_d = sum(s.queue_depth for s in snaps) / n
        num = sum(
            ((s.t - t0) - mean_t) * (s.queue_depth - mean_d) for s in snaps
        )
        den = sum(((s.t - t0) - mean_t) ** 2 for s in snaps)
        return num / den if den > 0 else 0.0
