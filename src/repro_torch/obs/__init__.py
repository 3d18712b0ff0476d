"""repro_torch.obs — observability for the serving stack (the port of ``repro.obs``).

Core primitives, all stdlib + thread-safe, shared by
`repro_torch.serving`:

  * :class:`LatencyHistogram` — fixed log-spaced buckets, constant
    memory, exact counts, mergeable across instances by bucket-wise
    addition.  The bounds and the ``state()``/``from_state()`` JSON are
    the JAX package's, so histograms of either package merge exactly.
  * :class:`TraceBuffer` / :class:`RequestTrace` — per-request spans
    (queue → batch assembly → device step → response write) plus
    structured lifecycle events in one bounded in-process ring.
    :func:`adopt_request_id` sanitizes a client-minted request id so one
    id names a request across hops.
  * :class:`MetricsWindow` / :class:`WindowSnapshot` — bounded window
    of timestamped cumulative snapshots deriving exact time series
    (request/shed rates, queue-depth trajectory + slope, SLO burn)
    from first-to-last deltas, never averaged rates.
  * :func:`render_prometheus` — Prometheus text exposition (``uhd_*``
    counters/gauges/histograms), byte-identical to the JAX package's for
    the same metrics; :func:`parse_exposition` is its strict inverse.

Plus the device-step profiling hooks: :func:`span` (a named stretch of
host code, recorded between :func:`record_spans` and :func:`take_spans`),
:class:`timed_block` (a timing span that waits on an event of the
current stream) and :func:`profile_capture` (an opt-in ``torch.profiler``
trace window, the spans written into it).
"""

from repro_torch.obs.histogram import LatencyHistogram  # noqa: F401
from repro_torch.obs.profiler import (  # noqa: F401
    Span,
    profile_capture,
    record_spans,
    span,
    take_spans,
    timed_block,
)
from repro_torch.obs.prometheus import (  # noqa: F401
    parse_exposition,
    render_prometheus,
)
from repro_torch.obs.trace import (  # noqa: F401
    OWNER_BATCHER,
    OWNER_TRANSPORT,
    RequestTrace,
    TraceBuffer,
    adopt_request_id,
    new_request_id,
)
from repro_torch.obs.window import MetricsWindow, WindowSnapshot  # noqa: F401
