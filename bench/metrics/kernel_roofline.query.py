"""The kernels' share of their roofline, in %: the counted least time of
the stretch's steps over the summed time of its kernels (copies left out)."""

from bench.shares import kernel_roofline


def read(run):
    return kernel_roofline(run["summary"])
