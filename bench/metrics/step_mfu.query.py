"""The whole step's share of the chip's peak, in %: the counted least time
of the stretch's steps over the stretch's wall time (``bench.counts``)."""

from bench.shares import step_mfu


def read(run):
    return step_mfu(run["summary"])
