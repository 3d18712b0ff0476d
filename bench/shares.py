"""The per-layer readings of a traced stretch (``tracing.Summary``).

Each returns None where the stretch holds nothing to read, and the harness
then leaves the metric out of the line.  A share of the peak or of the
roofline is the counted least time of the stretch's steps
(``bench.counts``) over a measured time, so no implementation reads above
100 unless a count or a time is wrong.
"""

from __future__ import annotations

import math


def _reads(s) -> bool:
    """The stretch holds device time to read."""
    return s is not None and s.busy_s > 0


def step_mfu(s):
    if not _reads(s) or s.steps == 0:
        return None
    return 100.0 * s.least_s / s.window_s


def kernel_roofline(s):
    if not _reads(s) or s.steps == 0 or s.kernel_s <= 0:
        return None
    return 100.0 * s.least_s / s.kernel_s


def device_idle_share(s):
    if not _reads(s):
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def block_p95_ms(s):
    if s is None or not s.block_ms:
        return None
    ms = sorted(s.block_ms)
    return ms[math.ceil(0.95 * len(ms)) - 1]
