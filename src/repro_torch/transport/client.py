"""`HdcClient`: stdlib HTTP client for the HDC serving front-end.

The torch package's copy of ``repro.transport.client`` (stdlib and
numpy; request ids from `repro_torch.obs.trace`).  It speaks the same
wire protocol, so it drives a server of either package.

A thin, dependency-free wrapper over `http.client` that speaks the
protocol module's two planes: JSON for control (health, models,
metrics, debuggable predict) and raw little-endian f32/i32 bytes for
the hot path (`predict_batch(..., binary=True)`).  Used by the tests,
the ``serve_http``, ``serve_online`` and ``obs_agg`` smoke drivers, and
the fleet aggregator's `HttpTarget`.

One client wraps one keep-alive connection and is **not** thread-safe —
the load generator gives each worker thread its own client, exactly as
a real fleet gives each connection its own socket.  A server restart
between requests surfaces as a stale keep-alive socket; `_request`
reconnects and retries once, which is safe because every route here is
idempotent (predictions are pure).
"""

from __future__ import annotations

import http.client
import json
from urllib.parse import urlencode

import numpy as np

from repro_torch.obs.trace import new_request_id
from repro_torch.transport import protocol


class TransportError(RuntimeError):
    """Non-2xx response from the serving front-end."""

    def __init__(self, status: int, message: str, payload: dict | None = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = int(status)
        self.payload = payload or {}


class OverloadedError(TransportError):
    """429: admission control shed the request; safe to retry later."""


class HdcClient:
    def __init__(self, host: str, port: int, *, timeout_s: float = 30.0):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self._conn: http.client.HTTPConnection | None = None
        #: id sent with the most recent predict call (cross-hop tracing:
        #: the server adopts it, so `/v1/traces?id=<last_request_id>` —
        #: on the server *or* the fleet aggregator — resolves the spans
        #: of the request this client just made)
        self.last_request_id: str | None = None

    # -- plumbing ----------------------------------------------------------

    def _connect(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s
            )
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "HdcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(
        self,
        method: str,
        path: str,
        body: bytes | None = None,
        headers: dict[str, str] | None = None,
    ) -> tuple[int, str, bytes]:
        """One round-trip; retries once on a stale keep-alive socket."""
        for attempt in (0, 1):
            conn = self._connect()
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                payload = resp.read()
                return resp.status, resp.headers.get_content_type(), payload
            except (http.client.HTTPException, ConnectionError, BrokenPipeError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _raise_for_status(status: int, content_type: str, payload: bytes):
        """Returns the parsed JSON body (or None); raises on >= 400."""
        obj = None
        if content_type == protocol.CT_JSON and payload:
            obj = json.loads(payload)
        if status >= 400:
            message = (obj or {}).get("error", payload.decode("utf-8", "replace"))
            err = OverloadedError if status == 429 else TransportError
            raise err(status, message, obj)
        return obj

    def _json(self, method: str, path: str, body: bytes | None = None,
              headers: dict[str, str] | None = None):
        status, content_type, payload = self._request(method, path, body, headers)
        obj = self._raise_for_status(status, content_type, payload)
        return obj if obj is not None else payload

    # -- control plane -----------------------------------------------------

    def healthz(self) -> dict:
        return self._json("GET", protocol.ROUTE_HEALTH)

    def models(self) -> dict:
        return self._json("GET", protocol.ROUTE_MODELS)["models"]

    def metrics(self, *, prometheus: bool = False) -> dict | str:
        """Per-model metrics snapshot.  JSON dict by default;
        ``prometheus=True`` negotiates the text exposition (returned as
        a str, for scrapers and the stage-breakdown benchmarks)."""
        if not prometheus:
            return self._json("GET", protocol.ROUTE_METRICS)
        return self.metrics_prometheus()

    def metrics_prometheus(self) -> str:
        status, content_type, payload = self._request(
            "GET", protocol.ROUTE_METRICS, headers={"Accept": "text/plain"}
        )
        self._raise_for_status(status, content_type, payload)
        if content_type != "text/plain":
            raise TransportError(
                status, f"expected text/plain exposition, got {content_type}"
            )
        return payload.decode("utf-8")

    def metrics_state(self) -> dict:
        """Full-fidelity cumulative metrics (`GET /metrics?detail=state`):
        per model, every counter plus the exact histogram buckets —
        the fleet aggregator's scrape call.  Reconstruct with
        `ServingMetrics.from_state` and merge across processes;
        the result is bit-identical to merging the live instances."""
        return self._json(
            "GET",
            f"{protocol.ROUTE_METRICS}?detail={protocol.METRICS_DETAIL_STATE}",
        )

    def traces(
        self,
        *,
        n: int | None = None,
        kind: str | None = None,
        model: str | None = None,
        request_id: str | None = None,
    ) -> list[dict]:
        """Last-n entries from the server's trace ring: request span
        dicts (kind="request") interleaved with lifecycle events
        (kind="event" — watcher promotions, learner publishes).
        ``request_id`` looks up one exact trace — the target of a
        tail-latency exemplar from the metrics snapshot."""
        params = {
            k: v
            for k, v in (
                ("n", n), ("kind", kind), ("model", model), ("id", request_id),
            )
            if v is not None
        }
        path = protocol.ROUTE_TRACES
        if params:
            path = f"{path}?{urlencode(params)}"
        return self._json("GET", path)["traces"]

    # -- predict -----------------------------------------------------------

    def _trace_headers(self, request_id: str | None) -> dict[str, str]:
        """Mint (or adopt the caller's) request id and remember it in
        `last_request_id` — the handle for resolving this request's
        spans at any hop (`traces(request_id=...)`, or the fleet
        aggregator's ``/v1/traces?id=``)."""
        rid = request_id or new_request_id("cli")
        self.last_request_id = rid
        return {protocol.HDR_REQUEST_ID: rid}

    def predict(self, name: str, image, *, request_id: str | None = None) -> int:
        """Single image over the JSON control form -> int label."""
        body = json.dumps(
            {"image": np.asarray(image, np.float32).ravel().tolist()}
        ).encode()
        out = self._json(
            "POST", protocol.predict_path(name), body,
            {"Content-Type": protocol.CT_JSON,
             **self._trace_headers(request_id)},
        )
        return int(out["label"])

    def predict_batch(
        self,
        name: str,
        images,
        *,
        binary: bool = True,
        request_id: str | None = None,
    ) -> np.ndarray:
        """(n, H) images -> (n,) int32 labels.

        `binary=True` is the hot path: raw f32 out, raw i32 back.
        `binary=False` exercises the JSON batch form.  Either way the
        request carries an ``x-hdc-request-id`` (minted here unless
        `request_id` is given); a batch of n fans out to slot traces
        ``<id>/0`` .. ``<id>/n-1`` on the server.
        """
        images = np.asarray(images, np.float32)
        if binary:
            status, content_type, payload = self._request(
                "POST",
                protocol.predict_path(name),
                protocol.encode_images(images),
                {"Content-Type": protocol.CT_F32, "Accept": protocol.CT_I32,
                 **self._trace_headers(request_id)},
            )
            self._raise_for_status(status, content_type, payload)
            if content_type != protocol.CT_I32:
                raise TransportError(
                    status, f"expected {protocol.CT_I32} body, got {content_type}"
                )
            return protocol.decode_labels(payload)
        body = json.dumps({"images": images.tolist()}).encode()
        out = self._json(
            "POST", protocol.predict_path(name), body,
            {"Content-Type": protocol.CT_JSON,
             **self._trace_headers(request_id)},
        )
        return np.asarray(out["labels"], np.int32)

    # -- search (top-k scored retrieval, DESIGN.md §14) --------------------

    def search(
        self,
        name: str,
        queries,
        k: int = 1,
        *,
        binary: bool = True,
        request_id: str | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(n, H) queries -> ((n, k) int32 indices, (n, k) int32 Hamming
        distances), each row ascending by (distance, index) with the
        lowest index winning ties.

        `binary=True` is the hot path: raw f32 query rows out (``k`` on
        the query string), raw back-to-back i32 index/distance blocks
        returned.  `binary=False` exercises the JSON batch form.  At
        ``k=1`` the index column equals `predict_batch`'s labels
        bit-for-bit — search is the scored generalization of predict.
        """
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        k = int(k)
        if binary:
            status, content_type, payload = self._request(
                "POST",
                f"{protocol.search_path(name)}?k={k}",
                protocol.encode_images(queries),
                {"Content-Type": protocol.CT_F32, "Accept": protocol.CT_I32,
                 **self._trace_headers(request_id)},
            )
            self._raise_for_status(status, content_type, payload)
            if content_type != protocol.CT_I32:
                raise TransportError(
                    status, f"expected {protocol.CT_I32} body, got {content_type}"
                )
            return protocol.decode_search_result(payload, k)
        body = json.dumps({"queries": queries.tolist(), "k": k}).encode()
        out = self._json(
            "POST", protocol.search_path(name), body,
            {"Content-Type": protocol.CT_JSON,
             **self._trace_headers(request_id)},
        )
        return (
            np.asarray(out["indices"], np.int32),
            np.asarray(out["distances"], np.int32),
        )

    # -- feedback (online learning, DESIGN.md §10) -------------------------

    def feedback(self, name: str, images, labels, *, binary: bool = True) -> dict:
        """POST labeled examples for the model's online learner.

        Returns the ack dict (``{"accepted": n, "buffered": depth}``).
        Raises `OverloadedError` (429) when the feedback buffer sheds
        the block — the block was *not* ingested and is safe to re-send
        later.  Note the shared stale-socket retry: a reconnect across
        an ambiguous failure (response lost after the server read the
        request) can deliver a block twice — acceptable for additive
        HDC feedback, but a stronger exactly-once story needs
        client-side dedup keys.
        """
        if binary:
            out = self._json(
                "POST", protocol.feedback_path(name),
                protocol.encode_feedback(images, labels),
                {"Content-Type": protocol.CT_F32},
            )
            return out
        body = json.dumps({
            "images": np.asarray(images, np.float32).tolist(),
            "labels": np.asarray(labels, np.int64).tolist(),
        }).encode()
        return self._json(
            "POST", protocol.feedback_path(name), body,
            {"Content-Type": protocol.CT_JSON},
        )
