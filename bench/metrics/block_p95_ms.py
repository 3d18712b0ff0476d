"""The 95th percentile, nearest rank, of the time from a block handed to
the entry to its answers on the host, over the window's blocks outside
the profiled stretch (host clock)."""

from bench.shares import block_p95_ms


def read(run):
    return block_p95_ms(run["summary"])
