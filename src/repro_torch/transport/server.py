"""`HdcHttpServer`: the network front-end over `repro_torch.serving`.

The torch counterpart of ``repro.transport.server``: the same routes,
status codes, JSON bodies, raw binary bodies, headers and admission
control, byte for byte, so a client of either package cannot tell the
two servers apart (``tests/test_torch_transport.py`` replays one
scripted request list against both).

Stdlib-only (asyncio + `http.HTTPStatus`): one event loop on a
dedicated daemon thread accepts HTTP/1.1 keep-alive connections and
bridges them to the *threaded* serving stack.  The bridge is
callback-based, not executor-based — `ServingFuture.add_done_callback`
posts the drain thread's resolution back onto the loop with
`call_soon_threadsafe`, so 10k in-flight requests cost 10k small
futures, not 10k blocked threads.

The loop thread never touches a tensor on the card: it decodes bodies
into numpy, admits them through ``submit_block`` /
``submit_search_block``, and encodes the host results that the drain
thread's futures deliver (the engine copies its labels to the host on
its own stream).  Device work stays on the drain threads, the watcher
and the learner.

The HTTP machinery itself (lifecycle, keep-alive connection handling,
request parse, response write, drain-aware shutdown) lives in
:class:`AsyncHttpServer`, a routing-free base class; `HdcHttpServer`
adds the serving routes, and the fleet aggregator's front-end
(`repro_torch.obs.aggregator.AggregatorServer`) adds its own on the same
base — one HTTP implementation, audited once.

Routes (DESIGN.md §8, §10, §13):

  * ``POST /v1/models/{name}:predict`` — single or batch.  JSON control
    form or the raw little-endian ``application/x-hdc-f32`` hot path;
    ``Accept: application/x-hdc-i32`` selects raw int32 labels back.
    An ``x-hdc-request-id`` header is *adopted* (after strict
    sanitization) instead of minting, so a client-minted id names the
    request across hops — client, server, pool replica, device step.
  * ``POST /v1/models/{name}:search`` — top-k scored retrieval against
    the model's pack-once class-word store (DESIGN.md §14).  Same two
    forms as predict: JSON (``{"query"/"queries", "k"}``) or raw
    ``application/x-hdc-f32`` query rows with ``?k=`` on the query
    string; ``Accept: application/x-hdc-i32`` returns the raw (n, k)
    int32 indices followed by the (n, k) int32 Hamming distances.
    ``k=1`` indices are bit-identical to predict's labels.
  * ``POST /v1/models/{name}:feedback`` — labeled examples for the
    model's `OnlineLearner`.  Labels are validated at the boundary
    (`encoding.validate_labels`; out-of-range or shape mismatch -> 400)
    and enqueued into the learner's bounded `FeedbackBuffer` — a full
    buffer sheds the whole block with a 429, *never* blocking the
    predict path on training.
  * ``GET /healthz`` — liveness + per-model step/placement/queue-depth/
    watcher; pool entries add per-replica step/depth/inflight.
  * ``GET /v1/models`` — entry description per model: engine
    `describe()` (including ``codebook_bytes``, the uHD deployment
    headline) plus placement, and the per-replica fleet for pools.
  * ``GET /metrics`` — `ServingMetrics.snapshot()` per model as strict
    JSON by default (fleet-merged for pool entries); ``Accept:
    text/plain`` negotiates Prometheus text exposition instead
    (``uhd_*`` families, with a ``replica`` label for pools,
    DESIGN.md §11-§12); ``?detail=state`` serves the full-fidelity
    cumulative scrape form (`ModelRegistry.metrics_state`) that the
    fleet aggregator merges bit-identically.
  * ``GET /v1/traces`` — last-n per-request spans + lifecycle events
    from the shared trace ring (``?n=&kind=&model=&id=`` filters;
    ``id`` resolves a tail-latency exemplar to its full trace, and an
    unknown id is a 404 with a JSON error body, not an empty list).
  * ``POST /v1/debug/profile?ms=N`` — opt-in ``torch.profiler`` capture
    window with the program's host spans written into its trace
    (`repro_torch.obs.profiler.profile_capture`); 403 unless the
    server was started with ``enable_profiling=True``, 409 while another
    capture runs.

Admission control — overload degrades loudly instead of OOMing:

  * bounded queue depth (the batcher's own ``max_depth`` if set, else
    the server-wide ``max_queue_depth``) -> **429** + the model's
    ``n_shed`` counter;
  * oversize payload (``Content-Length > max_body_bytes``) -> **413**
    without buffering the body;
  * submits racing a stopping batcher -> **503** + ``n_rejected`` (the
    registry rejects-after-stop instead of silently dropping futures).
"""

from __future__ import annotations

import asyncio
import json
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import Callable
from urllib.parse import parse_qs, unquote, urlsplit

from repro_torch.core import encoding
from repro_torch.obs import profiler as _profiler
from repro_torch.obs.prometheus import render_prometheus
from repro_torch.obs.trace import OWNER_TRANSPORT, adopt_request_id, new_request_id
from repro_torch.serving.batcher import QueueFull
from repro_torch.serving.registry import ModelRegistry
from repro_torch.transport import protocol

_DISCARD_CHUNK = 1 << 20


@dataclass
class _Request:
    method: str
    path: str
    headers: dict[str, str]
    body: bytes
    keep_alive: bool
    oversize: int = 0  # nonzero: declared Content-Length that was refused
    query: dict[str, str] = field(default_factory=dict)  # first value wins

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


@dataclass
class _Response:
    status: HTTPStatus
    body: bytes
    content_type: str
    extra_headers: dict[str, str] = field(default_factory=dict)
    # invoked exactly once after the response bytes hit the socket (or
    # the write fails) — the predict path uses this to close the
    # response-write span, so a trace's e2e covers the flush
    on_written: Callable[[], None] | None = None

    @classmethod
    def json(cls, status: HTTPStatus, obj) -> "_Response":
        # strict JSON at the boundary: NaN/Inf become null, and
        # allow_nan=False turns any stowaway into a loud 500 instead of
        # emitting a literal `NaN` every strict parser rejects
        body = json.dumps(protocol.sanitize_json(obj), allow_nan=False)
        return cls(status, body.encode(), protocol.CT_JSON)

    @classmethod
    def error(cls, status: HTTPStatus, message: str, **extra) -> "_Response":
        return cls.json(status, {"error": message, **extra})


# public names for subclass implementations outside this module
Request = _Request
Response = _Response


class AsyncHttpServer:
    """Routing-free asyncio HTTP/1.1 server on a daemon loop thread.

    Owns everything protocol-level: bind/teardown, keep-alive
    connection handling, request parsing (with oversize-payload refusal
    that drains the wire without buffering), response writing (with the
    exactly-once ``on_written`` callback), and drain-aware shutdown
    (idle keep-alive connections are cancelled immediately; connections
    mid-request get the drain window).  Subclasses implement one
    coroutine, :meth:`_route`, mapping a :class:`_Request` to a
    :class:`_Response`; any exception it leaks answers 500 on the same
    connection instead of killing it.
    """

    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body_bytes: int = 32 << 20,
        request_timeout_s: float = 60.0,
        thread_name: str = "hdc-http-loop",
    ):
        self.host = host
        self.port = port  # 0 -> ephemeral; rewritten to the bound port
        self.max_body_bytes = int(max_body_bytes)
        self.request_timeout_s = float(request_timeout_s)
        self._thread_name = thread_name
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._closing = False
        # task -> busy flag: True while a fully-read request is being
        # served, False while idle between keep-alive requests (only the
        # loop thread touches this)
        self._conns: dict[asyncio.Task, list[bool]] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Bind and serve on a background event-loop thread; returns
        self once the socket is listening (`self.port` holds the bound
        port)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name=self._thread_name, daemon=True
        )
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._bind(), self._loop)
        fut.result(timeout=30.0)
        return self

    async def _bind(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    def stop(self, *, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop accepting, then (with `drain`) wait for in-flight
        connections to finish before tearing the loop down.  Idempotent.
        Does not touch whatever the subclass serves from —
        `ModelRegistry.shutdown()` is the serving caller's next line
        (watchers -> batcher drain -> engines)."""
        loop, self._loop = self._loop, None
        thread, self._thread = self._thread, None
        if loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(
            self._shutdown(drain=drain, timeout_s=timeout_s), loop
        )
        fut.result(timeout=timeout_s + 10.0)
        loop.call_soon_threadsafe(loop.stop)
        if thread is not None:
            thread.join()
        loop.close()

    async def _shutdown(self, *, drain: bool, timeout_s: float) -> None:
        self._closing = True
        server, self._server = self._server, None
        if server is not None:
            server.close()  # stop accepting
        # idle keep-alive connections (parked in readline waiting for a
        # next request) are cancelled immediately; busy ones — a request
        # is being served — get the drain window
        for task, busy in list(self._conns.items()):
            if not task.done() and not (drain and busy[0]):
                task.cancel()
        tasks = [t for t in self._conns if not t.done()]
        if tasks:
            done, pending = await asyncio.wait(tasks, timeout=timeout_s)
            for t in pending:  # stragglers past the drain window
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
        if server is not None:
            # last: from Python 3.12.1 on, wait_closed() also waits for
            # every open connection, so awaiting it before the idle
            # keep-alive connections are cancelled would hang until the
            # caller's timeout (as ``repro.transport.server`` does there)
            await server.wait_closed()

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    # -- connection handling ----------------------------------------------

    async def _handle_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        busy = [False]
        if task is not None:
            self._conns[task] = busy
            task.add_done_callback(lambda t: self._conns.pop(t, None))
        try:
            while not self._closing:
                request = await self._read_request(reader)
                if request is None:
                    break
                busy[0] = True
                if request.oversize:
                    response = _Response.error(
                        HTTPStatus.REQUEST_ENTITY_TOO_LARGE,
                        f"payload of {request.oversize} bytes exceeds "
                        f"max_body_bytes={self.max_body_bytes}",
                    )
                else:
                    response = await self._dispatch(request)
                keep_alive = request.keep_alive and not self._closing
                await self._write_response(writer, response, keep_alive)
                busy[0] = False
                if not keep_alive:
                    break
        except (
            asyncio.IncompleteReadError,
            asyncio.LimitOverrunError,
            ConnectionError,
            asyncio.CancelledError,
        ):
            pass  # client went away / shutdown cancelled us mid-read
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    async def _read_request(self, reader) -> _Request | None:
        line = await reader.readline()
        if not line:
            return None  # clean EOF between keep-alive requests
        try:
            method, target, version = line.decode("latin-1").split()
        except ValueError:
            raise ConnectionError("malformed request line") from None
        headers: dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            key, _, value = raw.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        keep_alive = headers.get("connection", "").lower() != "close" and (
            version.upper() != "HTTP/1.0"
        )
        length = int(headers.get("content-length", "0") or "0")
        parts = urlsplit(target)
        path = unquote(parts.path)
        query = {k: v[0] for k, v in parse_qs(parts.query).items()}
        if length > self.max_body_bytes:
            # refuse without buffering: drain the wire in small chunks so
            # the connection stays usable, but never hold the payload
            remaining = length
            while remaining > 0:
                chunk = await reader.read(min(_DISCARD_CHUNK, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)
            return _Request(
                method, path, headers, b"", keep_alive,
                oversize=length, query=query,
            )
        body = await reader.readexactly(length) if length else b""
        return _Request(method, path, headers, body, keep_alive, query=query)

    async def _write_response(
        self, writer, response: _Response, keep_alive: bool
    ) -> None:
        status = response.status
        head = [
            f"HTTP/1.1 {status.value} {status.phrase}",
            f"Content-Type: {response.content_type}",
            f"Content-Length: {len(response.body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}",
        ]
        head += [f"{k}: {v}" for k, v in response.extra_headers.items()]
        try:
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
            writer.write(response.body)
            await writer.drain()
        finally:
            # fire even on a failed write so transport-owned traces are
            # always finalized into the ring, never leaked
            if response.on_written is not None:
                callback, response.on_written = response.on_written, None
                try:
                    callback()
                except Exception:
                    pass  # observability must never break the connection

    # -- routing -----------------------------------------------------------

    async def _dispatch(self, request: _Request) -> _Response:
        try:
            return await self._route(request)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a handler bug or a teardown race must answer 500, not kill
            # the connection with no status line
            return _Response.error(
                HTTPStatus.INTERNAL_SERVER_ERROR, f"{type(e).__name__}: {e}"
            )

    async def _route(self, request: _Request) -> _Response:
        raise NotImplementedError("subclasses implement _route")


class HdcHttpServer(AsyncHttpServer):
    """Asyncio HTTP/1.1 front-end for a `ModelRegistry`."""

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue_depth: int | None = 1024,
        max_body_bytes: int = 32 << 20,
        request_timeout_s: float = 60.0,
        enable_profiling: bool = False,
        profile_dir: str | None = None,
    ):
        super().__init__(
            host=host, port=port, max_body_bytes=max_body_bytes,
            request_timeout_s=request_timeout_s, thread_name="hdc-http-loop",
        )
        self.registry = registry
        self.max_queue_depth = max_queue_depth
        # POST /v1/debug/profile is 403 unless explicitly enabled: a
        # profiler capture stalls the device and writes to disk, so it
        # must be an operator decision, never a default
        self.enable_profiling = bool(enable_profiling)
        self.profile_dir = profile_dir

    # -- routing -----------------------------------------------------------

    async def _route(self, request: _Request) -> _Response:
        method, path = request.method.upper(), request.path
        if path == protocol.ROUTE_HEALTH and method == "GET":
            return self._health()
        if path == protocol.ROUTE_MODELS and method == "GET":
            return self._models()
        if path == protocol.ROUTE_METRICS and method == "GET":
            return self._metrics(request)
        if path == protocol.ROUTE_TRACES and method == "GET":
            return self._traces(request)
        if path == protocol.ROUTE_PROFILE:
            if method != "POST":
                return _Response.error(
                    HTTPStatus.METHOD_NOT_ALLOWED, "profile capture is POST-only"
                )
            return await self._profile(request)
        if path.startswith(protocol.ROUTE_MODELS + "/") and path.endswith(
            protocol.PREDICT_SUFFIX
        ):
            name = path[len(protocol.ROUTE_MODELS) + 1 : -len(protocol.PREDICT_SUFFIX)]
            if method != "POST":
                return _Response.error(
                    HTTPStatus.METHOD_NOT_ALLOWED, "predict is POST-only"
                )
            return await self._predict(name, request)
        if path.startswith(protocol.ROUTE_MODELS + "/") and path.endswith(
            protocol.SEARCH_SUFFIX
        ):
            name = path[len(protocol.ROUTE_MODELS) + 1 : -len(protocol.SEARCH_SUFFIX)]
            if method != "POST":
                return _Response.error(
                    HTTPStatus.METHOD_NOT_ALLOWED, "search is POST-only"
                )
            return await self._search(name, request)
        if path.startswith(protocol.ROUTE_MODELS + "/") and path.endswith(
            protocol.FEEDBACK_SUFFIX
        ):
            name = path[len(protocol.ROUTE_MODELS) + 1 : -len(protocol.FEEDBACK_SUFFIX)]
            if method != "POST":
                return _Response.error(
                    HTTPStatus.METHOD_NOT_ALLOWED, "feedback is POST-only"
                )
            return self._feedback(name, request)
        return _Response.error(HTTPStatus.NOT_FOUND, f"no route {method} {path}")

    def _models(self) -> _Response:
        models = {}
        for name in self.registry.names():
            try:
                # entry-level description: a pool reports its fleet
                # (placement "pool" + per-replica engine details), a
                # single engine reports itself
                models[name] = self.registry.describe_entry(name)
            except KeyError:  # racing an unregister
                continue
        return _Response.json(HTTPStatus.OK, {"models": models})

    def _health(self) -> _Response:
        models = {}
        for name in self.registry.names():
            try:
                engine = self.registry.engine(name)
                batcher = self.registry.batcher(name)
            except KeyError:  # racing an unregister
                continue
            watcher = self.registry.watcher(name)
            learner = self.registry.learner(name)
            entry = {
                "step": engine.step,
                "placement": getattr(
                    batcher, "placement", engine.execution.placement
                ),
                "queue_depth": batcher.queue_depth(),
                "watcher": None if watcher is None else watcher.describe(),
                "learner": None if learner is None else learner.describe(),
            }
            replicas = getattr(batcher, "replicas", None)
            if replicas is not None:  # ReplicaPool: per-replica liveness
                draining = set(getattr(batcher, "draining", ()) or ())
                entry["replicas"] = [
                    {
                        "replica": i,
                        "step": r.engine.step,
                        "queue_depth": r.queue_depth(),
                        "inflight": r.metrics.inflight,
                        "draining": i in draining,
                    }
                    for i, r in enumerate(replicas)
                ]
                entry["draining"] = sorted(draining)
            models[name] = entry
        return _Response.json(HTTPStatus.OK, {"status": "ok", "models": models})

    def _metrics(self, request: _Request) -> _Response:
        # three forms, one endpoint: `?detail=state` is the aggregator's
        # full-fidelity cumulative scrape (exact buckets, merge-safe);
        # Accept: text/plain negotiates Prometheus exposition; everything
        # else keeps the JSON snapshot the smoke CLI has always read
        if request.query.get("detail") == protocol.METRICS_DETAIL_STATE:
            return _Response.json(HTTPStatus.OK, self.registry.metrics_state())
        if "text/plain" in request.header("accept", "").lower():
            return _Response(
                HTTPStatus.OK,
                render_prometheus(self.registry).encode(),
                protocol.CT_PROM,
            )
        out = {}
        for name in self.registry.names():
            try:
                batcher = self.registry.batcher(name)
            except KeyError:
                continue
            # a pool answers with the fleet-merged view (pool admission
            # counters + every replica's histograms, merged exactly);
            # the Prometheus form keeps the per-replica breakdown
            merged = getattr(batcher, "merged_metrics", None)
            snap = (merged() if merged is not None else batcher.metrics).snapshot()
            learner = self.registry.learner(name)
            if learner is not None:
                snap["online"] = learner.snapshot()
            out[name] = snap
        return _Response.json(HTTPStatus.OK, out)

    def _traces(self, request: _Request) -> _Response:
        """Last-n view of the shared trace ring, optionally filtered:
        ``GET /v1/traces?n=100&kind=request&model=mnist``;
        ``?id=<request_id>`` resolves one exact trace (the target of a
        tail-latency exemplar from `/metrics`) — a miss is a 404 with a
        JSON error body, so an exemplar pointing at an evicted ring
        entry fails loudly instead of returning an empty 200."""
        traces = getattr(self.registry, "traces", None)
        request_id = request.query.get("id")
        if traces is None:
            if request_id is not None:
                return _Response.error(
                    HTTPStatus.NOT_FOUND,
                    f"no trace with id {request_id!r}",
                    id=request_id,
                )
            return _Response.json(HTTPStatus.OK, {"traces": []})
        try:
            n = int(request.query["n"]) if "n" in request.query else None
        except ValueError:
            return _Response.error(
                HTTPStatus.BAD_REQUEST,
                f"n must be an integer, got {request.query['n']!r}",
            )
        kind = request.query.get("kind")
        if kind is not None and kind not in ("request", "event"):
            return _Response.error(
                HTTPStatus.BAD_REQUEST,
                f'kind must be "request" or "event", got {kind!r}',
            )
        entries = traces.snapshot(
            n,
            kind=kind,
            model=request.query.get("model"),
            request_id=request_id,
        )
        if request_id is not None and not entries:
            return _Response.error(
                HTTPStatus.NOT_FOUND,
                f"no trace with id {request_id!r} in the ring "
                "(evicted, or never finished)",
                id=request_id,
            )
        return _Response.json(HTTPStatus.OK, {"traces": entries})

    async def _profile(self, request: _Request) -> _Response:
        """Opt-in ``torch.profiler`` capture window (DESIGN.md §11).
        ``POST /v1/debug/profile?ms=N`` blocks for N ms while the
        profiler records, then returns the trace directory."""
        if not self.enable_profiling:
            return _Response.error(
                HTTPStatus.FORBIDDEN,
                "profiling is disabled; start the server with "
                "enable_profiling=True (serve_http --enable-profiling)",
            )
        try:
            ms = float(request.query.get("ms", "100"))
        except ValueError:
            return _Response.error(
                HTTPStatus.BAD_REQUEST,
                f"ms must be a number, got {request.query['ms']!r}",
            )
        if not 0 < ms <= 60_000:
            return _Response.error(
                HTTPStatus.BAD_REQUEST, f"ms must be in (0, 60000], got {ms:g}"
            )
        out_dir = tempfile.mkdtemp(prefix="uhd_profile_", dir=self.profile_dir)
        loop = asyncio.get_running_loop()
        try:
            # module attribute (not a direct import) so tests can stub
            # the capture; executor keeps the event loop serving while
            # the profiler sleeps through its window
            path = await loop.run_in_executor(
                None, _profiler.profile_capture, out_dir, ms
            )
        except RuntimeError as e:  # capture already in progress
            return _Response.error(HTTPStatus.CONFLICT, str(e))
        return _Response.json(HTTPStatus.OK, {"profile_dir": path, "ms": ms})

    # -- predict -----------------------------------------------------------

    async def _predict(self, name: str, request: _Request) -> _Response:
        try:
            batcher = self.registry.batcher(name)
        except KeyError:
            return _Response.error(
                HTTPStatus.NOT_FOUND,
                f"unknown model {name!r}",
                registered=list(self.registry.names()),
            )
        n_features = batcher.engine.model.cfg.n_features

        content_type = request.header("content-type", protocol.CT_JSON)
        content_type = content_type.split(";")[0].strip().lower()
        single = False
        try:
            if content_type == protocol.CT_F32:
                images = protocol.decode_images(request.body, n_features)
            elif content_type == protocol.CT_JSON:
                images, single = protocol.parse_predict_json(
                    json.loads(request.body or b"{}")
                )
            else:
                return _Response.error(
                    HTTPStatus.UNSUPPORTED_MEDIA_TYPE,
                    f"unsupported content type {content_type!r}; "
                    f"use {protocol.CT_JSON} or {protocol.CT_F32}",
                )
            if images.shape[1] != n_features:
                raise ValueError(
                    f"model {name!r} takes {n_features} features per image, "
                    f"got {images.shape[1]}"
                )
        # TypeError too: a JSON body with non-numeric entries (e.g. null)
        # raises it from np.asarray — that is a malformed payload (400),
        # not a server bug (500)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return _Response.error(HTTPStatus.BAD_REQUEST, str(e))

        # -- admission: bounded queue depth -> shed loudly ----------------
        limit = batcher.max_depth
        if limit is None:
            limit = self.max_queue_depth
        if limit is not None and batcher.queue_depth() + len(images) > limit:
            batcher.metrics.shed(len(images))
            return _Response.error(
                HTTPStatus.TOO_MANY_REQUESTS,
                f"model {name!r} overloaded: queue depth "
                f"{batcher.queue_depth()} + {len(images)} exceeds {limit}",
                retry=True,
            )

        loop = asyncio.get_running_loop()
        # cross-hop trace propagation: a sane x-hdc-request-id header is
        # adopted (the client minted it, so client and server logs share
        # one id); anything absent or hostile mints locally as before.
        # One span set per image (a batch of n fans out to "rid/i").
        rid = adopt_request_id(
            request.header(protocol.HDR_REQUEST_ID)
        ) or new_request_id()
        request_ids = (
            [rid] if len(images) == 1
            else [f"{rid}/{i}" for i in range(len(images))]
        )
        try:
            # all-or-nothing admission: a race with the depth bound or a
            # concurrent stop() can't strand a half-submitted batch
            futures = batcher.submit_block(
                images, request_ids=request_ids, trace_owner=OWNER_TRANSPORT
            )
        except QueueFull as e:  # batcher-level bound won the race; shed
            return _Response.error(HTTPStatus.TOO_MANY_REQUESTS, str(e), retry=True)
        except RuntimeError as e:  # stopping/stopped batcher: reject, 503
            return _Response.error(HTTPStatus.SERVICE_UNAVAILABLE, str(e))
        awaitables = [self._bridge(loop, fut) for fut in futures]

        try:
            labels = await asyncio.wait_for(
                asyncio.gather(*awaitables), timeout=self.request_timeout_s
            )
        except asyncio.TimeoutError:
            self._abort_traces(futures)
            return _Response.error(
                HTTPStatus.GATEWAY_TIMEOUT,
                f"request not served within {self.request_timeout_s}s",
            )
        except RuntimeError as e:  # batcher stopped without drain mid-flight
            self._abort_traces(futures)
            return _Response.error(HTTPStatus.SERVICE_UNAVAILABLE, str(e))
        except Exception as e:  # engine failure delivered through the future
            self._abort_traces(futures)
            return _Response.error(
                HTTPStatus.INTERNAL_SERVER_ERROR, f"{type(e).__name__}: {e}"
            )

        t_write_start = time.perf_counter()
        for fut in futures:
            if fut.trace is not None:
                fut.trace.t_write_start = t_write_start
        if protocol.CT_I32 in request.header("accept", ""):
            response = _Response(
                HTTPStatus.OK, protocol.encode_labels(labels), protocol.CT_I32
            )
        elif single:
            response = _Response.json(HTTPStatus.OK, {"label": int(labels[0])})
        else:
            response = _Response.json(
                HTTPStatus.OK, {"labels": [int(l) for l in labels]}
            )
        # echo the effective id so a client that did not mint one can
        # still resolve its trace (`/v1/traces?id=`) after the fact
        response.extra_headers[protocol.HDR_REQUEST_ID] = rid
        response.on_written = self._trace_writer(batcher, futures)
        return response

    # -- search (top-k scored retrieval, DESIGN.md §14) --------------------

    async def _search(self, name: str, request: _Request) -> _Response:
        """Top-k retrieval over the model's pack-once class-word store.

        Mirrors `_predict` end to end — same admission control, trace
        propagation, and micro-batching — but each slot resolves to an
        ``(indices, distances)`` row pair instead of a label.  ``k`` is
        bounded by the store's row count (the served model's
        ``n_classes``): asking for more neighbors than rows is a 400,
        never a silent truncation.
        """
        try:
            batcher = self.registry.batcher(name)
        except KeyError:
            return _Response.error(
                HTTPStatus.NOT_FOUND,
                f"unknown model {name!r}",
                registered=list(self.registry.names()),
            )
        cfg = batcher.engine.model.cfg
        n_features = cfg.n_features

        content_type = request.header("content-type", protocol.CT_JSON)
        content_type = content_type.split(";")[0].strip().lower()
        single = False
        try:
            if content_type == protocol.CT_F32:
                queries = protocol.decode_images(request.body, n_features)
                k = protocol.parse_k(request.query.get("k", "1"))
            elif content_type == protocol.CT_JSON:
                queries, k, single = protocol.parse_search_json(
                    json.loads(request.body or b"{}")
                )
            else:
                return _Response.error(
                    HTTPStatus.UNSUPPORTED_MEDIA_TYPE,
                    f"unsupported content type {content_type!r}; "
                    f"use {protocol.CT_JSON} or {protocol.CT_F32}",
                )
            if queries.shape[1] != n_features:
                raise ValueError(
                    f"model {name!r} takes {n_features} features per query, "
                    f"got {queries.shape[1]}"
                )
            if k > cfg.n_classes:
                raise ValueError(
                    f"k={k} exceeds the {cfg.n_classes} rows in model "
                    f"{name!r}'s store"
                )
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return _Response.error(HTTPStatus.BAD_REQUEST, str(e))

        # -- admission: same bounded queue depth as predict ----------------
        limit = batcher.max_depth
        if limit is None:
            limit = self.max_queue_depth
        if limit is not None and batcher.queue_depth() + len(queries) > limit:
            batcher.metrics.shed(len(queries))
            return _Response.error(
                HTTPStatus.TOO_MANY_REQUESTS,
                f"model {name!r} overloaded: queue depth "
                f"{batcher.queue_depth()} + {len(queries)} exceeds {limit}",
                retry=True,
            )

        loop = asyncio.get_running_loop()
        rid = adopt_request_id(
            request.header(protocol.HDR_REQUEST_ID)
        ) or new_request_id()
        request_ids = (
            [rid] if len(queries) == 1
            else [f"{rid}/{i}" for i in range(len(queries))]
        )
        try:
            futures = batcher.submit_search_block(
                queries, k, request_ids=request_ids, trace_owner=OWNER_TRANSPORT
            )
        except QueueFull as e:
            return _Response.error(HTTPStatus.TOO_MANY_REQUESTS, str(e), retry=True)
        except RuntimeError as e:  # stopping batcher, or fully-drained pool
            return _Response.error(HTTPStatus.SERVICE_UNAVAILABLE, str(e))
        awaitables = [self._bridge(loop, fut) for fut in futures]

        try:
            rows = await asyncio.wait_for(
                asyncio.gather(*awaitables), timeout=self.request_timeout_s
            )
        except asyncio.TimeoutError:
            self._abort_traces(futures)
            return _Response.error(
                HTTPStatus.GATEWAY_TIMEOUT,
                f"request not served within {self.request_timeout_s}s",
            )
        except RuntimeError as e:
            self._abort_traces(futures)
            return _Response.error(HTTPStatus.SERVICE_UNAVAILABLE, str(e))
        except Exception as e:
            self._abort_traces(futures)
            return _Response.error(
                HTTPStatus.INTERNAL_SERVER_ERROR, f"{type(e).__name__}: {e}"
            )

        t_write_start = time.perf_counter()
        for fut in futures:
            if fut.trace is not None:
                fut.trace.t_write_start = t_write_start
        indices = [row[0] for row in rows]
        distances = [row[1] for row in rows]
        if protocol.CT_I32 in request.header("accept", ""):
            response = _Response(
                HTTPStatus.OK,
                protocol.encode_search_result(indices, distances),
                protocol.CT_I32,
            )
        elif single:
            response = _Response.json(
                HTTPStatus.OK,
                {
                    "indices": [int(i) for i in indices[0]],
                    "distances": [int(d) for d in distances[0]],
                    "k": k,
                },
            )
        else:
            response = _Response.json(
                HTTPStatus.OK,
                {
                    "indices": [[int(i) for i in row] for row in indices],
                    "distances": [[int(d) for d in row] for row in distances],
                    "k": k,
                },
            )
        response.extra_headers[protocol.HDR_REQUEST_ID] = rid
        response.on_written = self._trace_writer(batcher, futures)
        return response

    def _trace_writer(self, batcher, futures) -> Callable[[], None]:
        """Closure run after the response bytes are flushed: closes each
        trace's write span and lands it in the shared ring — the trace's
        e2e therefore covers queue -> device -> socket flush."""

        def finish() -> None:
            t_end = time.perf_counter()
            traces = getattr(self.registry, "traces", None)
            for fut in futures:
                trace = fut.trace
                if trace is None:
                    continue
                trace.t_write_end = t_end
                if trace.t_write_start is not None:
                    batcher.metrics.observe_stage(
                        "write", t_end - trace.t_write_start
                    )
                entry = trace.finalize()
                if entry is not None and traces is not None:
                    traces.append(entry)

        return finish

    def _abort_traces(self, futures) -> None:
        """Finalize transport-owned traces on an error path (timeout,
        mid-flight stop, engine failure) so they land in the ring as
        errors instead of leaking unfinished."""
        traces = getattr(self.registry, "traces", None)
        for fut in futures:
            trace = fut.trace
            if trace is None:
                continue
            entry = trace.finalize(error=True)
            if entry is not None and traces is not None:
                traces.append(entry)

    # -- feedback (online learning ingest, DESIGN.md §10) ------------------

    def _feedback(self, name: str, request: _Request) -> _Response:
        """Validate a labeled block at the boundary and enqueue it for
        the model's learner.  Synchronous and non-blocking: the buffer
        put is a bounded lock-append, so feedback ingestion can never
        stall the predict path behind training."""
        try:
            batcher = self.registry.batcher(name)
        except KeyError:
            return _Response.error(
                HTTPStatus.NOT_FOUND,
                f"unknown model {name!r}",
                registered=list(self.registry.names()),
            )
        learner = self.registry.learner(name)
        if learner is None:
            return _Response.error(
                HTTPStatus.NOT_FOUND,
                f"model {name!r} has no online learner attached; "
                "feedback is not accepted",
            )
        cfg = batcher.engine.model.cfg
        content_type = request.header("content-type", protocol.CT_JSON)
        content_type = content_type.split(";")[0].strip().lower()
        try:
            if content_type == protocol.CT_F32:
                images, labels = protocol.decode_feedback(
                    request.body, cfg.n_features
                )
            elif content_type == protocol.CT_JSON:
                images, labels = protocol.parse_feedback_json(
                    json.loads(request.body or b"{}")
                )
            else:
                return _Response.error(
                    HTTPStatus.UNSUPPORTED_MEDIA_TYPE,
                    f"unsupported content type {content_type!r}; "
                    f"use {protocol.CT_JSON} or {protocol.CT_F32}",
                )
            if images.shape[1] != cfg.n_features:
                raise ValueError(
                    f"model {name!r} takes {cfg.n_features} features per "
                    f"image, got {images.shape[1]}"
                )
            # the same host-boundary contract as HDCModel.partial_fit:
            # out-of-range labels answer 400 here, never reach training
            encoding.validate_labels(labels, cfg.n_classes)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return _Response.error(HTTPStatus.BAD_REQUEST, str(e))

        try:
            accepted = learner.submit(images, labels)
        except RuntimeError as e:  # closed buffer: learner shutting down
            return _Response.error(HTTPStatus.SERVICE_UNAVAILABLE, str(e))
        if not accepted:
            return _Response.error(
                HTTPStatus.TOO_MANY_REQUESTS,
                f"model {name!r} feedback buffer full "
                f"({learner.buffer.capacity} examples); block shed",
                retry=True,
            )
        return _Response.json(
            HTTPStatus.OK,
            {"accepted": int(len(images)), "buffered": int(learner.buffer.depth())},
        )

    @staticmethod
    def _bridge(loop: asyncio.AbstractEventLoop, fut) -> asyncio.Future:
        """ServingFuture (threading) -> asyncio future on `loop`."""
        afut = loop.create_future()

        def settle(resolved) -> None:
            if afut.cancelled():
                return
            try:
                afut.set_result(resolved.result(timeout=0))
            except BaseException as e:
                afut.set_exception(e)

        fut.add_done_callback(
            lambda resolved: loop.call_soon_threadsafe(settle, resolved)
        )
        return afut
