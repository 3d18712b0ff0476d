"""Per-request trace spans + structured lifecycle events, in one ring.

The port's copy of ``repro.obs.trace`` (stdlib only).

A :class:`RequestTrace` rides on each :class:`ServingFuture` and is
stamped as the request crosses each stage boundary:

    submit ── queue ── dequeue ── assembly ── device step ── resolve
                                                  └─ write ── done

The owner (the HTTP transport for requests that arrived over the
socket, the batcher for direct `submit` callers) finalizes the trace
into a plain dict and appends it to the shared :class:`TraceBuffer` —
a bounded ring served by ``GET /v1/traces`` and exportable as JSONL.
Span sums are ≤ the end-to-end latency by construction: the four spans
are disjoint sub-intervals of [submit, done].

Lifecycle events (watcher promotions, learner publishes) go into a
*separate* bounded ring inside the same buffer, so a flood of request
traffic can never evict the promotion timeline; ``snapshot()`` merges
both in append order.  Events carry a monotonic ``t_mono`` so their
ordering against request spans is testable (e.g. a ``publish`` event
precedes the first span served by the promoted engine).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

OWNER_BATCHER = "batcher"
OWNER_TRANSPORT = "transport"

_SEQ = itertools.count()
_PID_TAG = f"{os.getpid():x}"


def new_request_id(prefix: str = "req") -> str:
    """Process-unique request id, minted at the HTTP boundary (or by
    `MicroBatcher.submit` for direct callers)."""
    return f"{prefix}-{_PID_TAG}-{next(_SEQ):08x}"


#: longest id accepted from the wire (x-hdc-request-id header)
MAX_REQUEST_ID_LEN = 128


def adopt_request_id(raw: str | None) -> str | None:
    """Validate a caller-supplied request id for cross-hop tracing.

    `HdcClient` mints an id and sends it as ``x-hdc-request-id``; the
    server *adopts* it instead of minting, so one id names the request
    from client through pool dispatch to device step, fleet-wide.  The
    id crosses a trust boundary, so adoption is strict: printable ASCII
    without whitespace/quotes/braces (it is embedded in JSON, JSONL,
    and Prometheus exemplar output), bounded length.  Returns None —
    mint locally — for anything unacceptable; a hostile header can
    degrade its own trace, never the ring or the exposition.
    """
    if not raw:
        return None
    rid = raw.strip()
    if not 0 < len(rid) <= MAX_REQUEST_ID_LEN:
        return None
    if any(c <= " " or c > "~" or c in '"\\{}' for c in rid):
        return None
    return rid


class RequestTrace:
    """Mutable per-request span marks (monotonic seconds).

    Stamped lock-free: each mark has exactly one writer (the submitter,
    the drain thread, or the transport loop) and is read only at
    :meth:`finalize`, after the last writer is done with it.
    """

    __slots__ = (
        "request_id", "model", "owner", "step", "replica", "error",
        "t_submit", "t_dequeue", "t_device_start", "t_device_end",
        "t_resolve", "t_write_start", "t_write_end", "_finalized",
    )

    def __init__(
        self,
        request_id: str | None = None,
        *,
        model: str | None = None,
        owner: str = OWNER_BATCHER,
        t_submit: float | None = None,
        replica: int | None = None,
    ):
        self.request_id = request_id or new_request_id()
        self.model = model
        self.owner = owner
        self.step: int | None = None
        self.replica = replica  # pool slot that served this request
        self.error = False
        self.t_submit = time.perf_counter() if t_submit is None else t_submit
        self.t_dequeue: float | None = None
        self.t_device_start: float | None = None
        self.t_device_end: float | None = None
        self.t_resolve: float | None = None
        self.t_write_start: float | None = None
        self.t_write_end: float | None = None
        self._finalized = False

    def finalize(self, *, error: bool = False) -> dict | None:
        """Freeze into a plain ring entry; idempotent (first call wins,
        later calls return None).  Missing marks collapse to the
        previous one, so a trace abandoned mid-path still yields
        well-formed zero-length spans.
        """
        if self._finalized:
            return None
        self._finalized = True
        t0 = self.t_submit
        td = self.t_dequeue if self.t_dequeue is not None else t0
        tds = self.t_device_start if self.t_device_start is not None else td
        tde = self.t_device_end if self.t_device_end is not None else tds
        tr = self.t_resolve if self.t_resolve is not None else tde
        tws = self.t_write_start if self.t_write_start is not None else tr
        twe = self.t_write_end if self.t_write_end is not None else tws
        return {
            "kind": "request",
            "id": self.request_id,
            "model": self.model,
            "step": self.step,
            "replica": self.replica,
            "error": bool(error or self.error),
            "ts": time.time(),
            "t_submit": t0,
            "t_device_start": tds,
            "t_done": twe,
            "e2e_ms": (twe - t0) * 1e3,
            "spans": {
                "queue_ms": (td - t0) * 1e3,
                "assembly_ms": (tds - td) * 1e3,
                "device_ms": (tde - tds) * 1e3,
                "write_ms": (twe - tws) * 1e3,
            },
        }


class TraceBuffer:
    """Bounded in-process ring of finished traces + lifecycle events.

    Thread-safe.  Requests and events live in separate deques (request
    floods cannot evict the low-rate promotion/publish timeline); a
    shared monotonic ``seq`` preserves global append order across both.
    With ``jsonl_path`` set, every ``jsonl_sample``-th appended entry is
    also written as one JSON line for offline analysis.
    """

    def __init__(
        self,
        capacity: int = 2048,
        *,
        event_capacity: int = 256,
        jsonl_path: str | os.PathLike | None = None,
        jsonl_sample: int = 1,
    ):
        self.capacity = int(capacity)
        self.event_capacity = int(event_capacity)
        self._requests: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._events: collections.deque[dict] = collections.deque(
            maxlen=event_capacity
        )
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.n_appended = 0
        self._jsonl_path = os.fspath(jsonl_path) if jsonl_path else None
        self._jsonl_sample = max(1, int(jsonl_sample))
        self._jsonl_file = None

    # -- writes ------------------------------------------------------------

    def append(self, entry: dict) -> dict:
        """Append one finished-trace/event dict (must be json.dumps-able)."""
        with self._lock:
            entry["seq"] = next(self._seq)
            (self._events if entry.get("kind") == "event" else self._requests).append(
                entry
            )
            self.n_appended += 1
            if self._jsonl_path and entry["seq"] % self._jsonl_sample == 0:
                self._write_jsonl(entry)
        return entry

    def record_event(
        self, event: str, *, model: str | None = None, t_mono: float | None = None,
        **fields,
    ) -> dict:
        """Append a structured lifecycle event (promotion, publish, ...).

        ``t_mono`` defaults to now; pass an explicit earlier mark (e.g.
        publish *start*) when the event's ordering against request
        spans matters.
        """
        return self.append({
            "kind": "event",
            "event": event,
            "model": model,
            "ts": time.time(),
            "t_mono": time.perf_counter() if t_mono is None else float(t_mono),
            **fields,
        })

    def _write_jsonl(self, entry: dict) -> None:
        try:
            if self._jsonl_file is None:
                self._jsonl_file = open(self._jsonl_path, "a", encoding="utf-8")
            self._jsonl_file.write(json.dumps(entry) + "\n")
            self._jsonl_file.flush()
        except OSError:  # a full disk must never take serving down
            pass

    def close(self) -> None:
        with self._lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None

    # -- reads -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._requests) + len(self._events)

    def snapshot(
        self,
        n: int | None = None,
        *,
        kind: str | None = None,
        model: str | None = None,
        request_id: str | None = None,
    ) -> list[dict]:
        """Entries in append order (newest last), optionally filtered by
        kind ("request"/"event"), model, and exact request id (the
        exemplar-lookup path: a tail bucket's ``trace_id`` resolves to
        its concrete trace via ``/v1/traces?id=``), truncated to the
        last n."""
        with self._lock:
            entries = sorted(
                itertools.chain(self._requests, self._events),
                key=lambda e: e["seq"],
            )
        if kind is not None:
            entries = [e for e in entries if e.get("kind") == kind]
        if model is not None:
            entries = [e for e in entries if e.get("model") == model]
        if request_id is not None:
            entries = [e for e in entries if e.get("id") == request_id]
        if n is not None and n >= 0:
            entries = entries[-n:]
        return entries

    def export_jsonl(self, path: str | os.PathLike, *, sample: int = 1) -> int:
        """Dump the current ring (every ``sample``-th entry) as JSONL;
        returns the number of lines written."""
        entries = self.snapshot()[:: max(1, int(sample))]
        with open(path, "w", encoding="utf-8") as f:
            for e in entries:
                f.write(json.dumps(e) + "\n")
        return len(entries)
