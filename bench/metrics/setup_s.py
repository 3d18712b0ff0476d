"""Process start to the first timed block (host clock): imports, the kernel
library's load (its build on a checkout's first run), data, fit or store,
graph capture, warm-up."""


def read(run):
    return run["setup_s"]
