"""The device's idle share of the stretch, in %: 1 - busy / wall, busy the
union of its kernel, copy and fill intervals."""

from bench.shares import device_idle_share


def read(run):
    return device_idle_share(run["summary"])
