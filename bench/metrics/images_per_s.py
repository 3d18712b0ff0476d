"""Query images answered in the window over the window's seconds (host
clock): every image of every block answered, over all the window."""


def read(run):
    return run["images"] / run["window_s"] if run["images"] else None
