"""Wire protocol for the HDC serving front-end (DESIGN.md §8).

A copy of ``repro.transport.protocol`` (stdlib and numpy only): the
content types, routes, codecs, parsers and their error messages are the
JAX package's byte for byte, so a client of either package talks to a
server of either.

Two planes, both over plain HTTP/1.1:

  * **control plane** — JSON.  Health, model listing, metrics, and the
    debuggable predict form (``{"image": [...]}`` / ``{"images":
    [[...], ...]}``) all speak ``application/json``.
  * **hot path** — raw little-endian binary.  A predict body of
    ``application/x-hdc-f32`` is the C-order bytes of an ``(n, H)``
    float32 image block (no framing: ``n`` is inferred from the body
    length, ``H`` from the target model's config), and a client that
    sends ``Accept: application/x-hdc-i32`` gets the ``(n,)`` int32
    labels back as raw bytes.  This keeps the per-request cost of a
    million-user front-end at one memcpy each way — no base64, no JSON
    float parsing on a 784-float image.

The feedback plane (``:feedback``, DESIGN.md §10) mirrors the predict
plane: a JSON form for debugging and a raw form (f32 image rows
followed by i32 labels, ``4H + 4`` bytes per example) for the
online-learning hot path.

The search plane (``:search``, DESIGN.md §14) generalizes predict to
scored top-k retrieval: queries travel exactly like predict images
(JSON ``{"query"/"queries", "k"}`` or raw ``x-hdc-f32`` rows with
``?k=`` on the query string), and the raw response under
``Accept: application/x-hdc-i32`` is the C-order ``(n, k)`` int32
indices followed by the ``(n, k)`` int32 Hamming distances, back to
back — ``n`` recovers from the body length given k, so the hot path
stays one memcpy each way.

Everything here is shared by `server` and `client` so the two ends can
never skew; the codec functions are pure and unit-tested in
``tests/test_transport.py`` and, against the JAX package's,
``tests/test_torch_transport.py``.
"""

from __future__ import annotations

import numpy as np

# content types
CT_JSON = "application/json"
CT_F32 = "application/x-hdc-f32"  # raw LE float32 image rows, C order
CT_I32 = "application/x-hdc-i32"  # raw LE int32 labels
CT_PROM = "text/plain; version=0.0.4; charset=utf-8"  # Prometheus exposition

# canonical routes
ROUTE_HEALTH = "/healthz"
ROUTE_MODELS = "/v1/models"
ROUTE_METRICS = "/metrics"
ROUTE_TRACES = "/v1/traces"
ROUTE_FLEET = "/v1/fleet"  # aggregator-only: per-target scrape health
ROUTE_PROFILE = "/v1/debug/profile"
PREDICT_SUFFIX = ":predict"
FEEDBACK_SUFFIX = ":feedback"
SEARCH_SUFFIX = ":search"

#: cross-hop trace propagation: the client mints a request id and sends
#: it here; the server adopts it (after `repro_torch.obs.trace.adopt_request_id`
#: sanitization) instead of minting, so one id names the request from
#: client through pool dispatch to device step, fleet-wide
HDR_REQUEST_ID = "x-hdc-request-id"

#: `GET /metrics?detail=state` — full-fidelity cumulative scrape format
#: (exact histogram buckets via `ServingMetrics.state()`), the fleet
#: aggregator's wire form; merged buckets are bit-identical to merging
#: the live instances, which parsed text exposition could never be
METRICS_DETAIL_STATE = "state"


def sanitize_json(obj):
    """Recursively replace NaN/±Inf floats with None so the result is
    strict JSON (``json.dumps(..., allow_nan=False)`` safe).  The old
    behavior — dumping a traffic-free snapshot's NaN percentiles as the
    literal ``NaN`` — produced output every strict parser rejects."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj

_F32 = np.dtype("<f4")
_I32 = np.dtype("<i4")


def predict_path(name: str) -> str:
    return f"{ROUTE_MODELS}/{name}{PREDICT_SUFFIX}"


def feedback_path(name: str) -> str:
    return f"{ROUTE_MODELS}/{name}{FEEDBACK_SUFFIX}"


def search_path(name: str) -> str:
    return f"{ROUTE_MODELS}/{name}{SEARCH_SUFFIX}"


def encode_images(images) -> bytes:
    """(n, H) or (H,) float-like -> raw little-endian float32 bytes."""
    arr = np.ascontiguousarray(np.asarray(images, _F32))
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"images must be (n, H) or (H,), got {arr.shape}")
    return arr.tobytes()


def decode_images(body: bytes, n_features: int) -> np.ndarray:
    """Raw f32 bytes -> (n, H) float32; loud on any length mismatch."""
    row_bytes = n_features * _F32.itemsize
    if len(body) == 0 or len(body) % row_bytes != 0:
        raise ValueError(
            f"binary image payload of {len(body)} bytes is not a positive "
            f"multiple of {row_bytes} (= {n_features} float32 features)"
        )
    return np.frombuffer(body, _F32).reshape(-1, n_features).astype(
        np.float32, copy=False
    )


def encode_labels(labels) -> bytes:
    return np.ascontiguousarray(np.asarray(labels, _I32).ravel()).tobytes()


def decode_labels(body: bytes) -> np.ndarray:
    if len(body) % _I32.itemsize != 0:
        raise ValueError(f"label payload of {len(body)} bytes is not int32-aligned")
    return np.frombuffer(body, _I32).astype(np.int32, copy=False)


def encode_feedback(images, labels) -> bytes:
    """Labeled block -> raw bytes: (n, H) LE float32 rows then (n,) LE
    int32 labels, back to back.  No framing — ``n`` is recovered from
    the body length (each example costs exactly ``4H + 4`` bytes), so
    the online-learning hot path stays one memcpy each way, like the
    predict plane."""
    arr = np.ascontiguousarray(np.asarray(images, _F32))
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"images must be (n, H) or (H,), got {arr.shape}")
    lab = np.ascontiguousarray(np.asarray(labels, _I32).ravel())
    if lab.shape != (len(arr),):
        raise ValueError(
            f"labels must be ({len(arr)},) to match images, got {lab.shape}"
        )
    return arr.tobytes() + lab.tobytes()


def decode_feedback(body: bytes, n_features: int) -> tuple[np.ndarray, np.ndarray]:
    """Raw feedback bytes -> ((n, H) float32, (n,) int32); loud on any
    length mismatch (the record size ``4H + 4`` must divide exactly)."""
    rec_bytes = n_features * _F32.itemsize + _I32.itemsize
    if len(body) == 0 or len(body) % rec_bytes != 0:
        raise ValueError(
            f"binary feedback payload of {len(body)} bytes is not a positive "
            f"multiple of {rec_bytes} (= {n_features} float32 features "
            "+ 1 int32 label per example)"
        )
    n = len(body) // rec_bytes
    split = n * n_features * _F32.itemsize
    images = np.frombuffer(body[:split], _F32).reshape(n, n_features)
    labels = np.frombuffer(body[split:], _I32)
    return (
        images.astype(np.float32, copy=False),
        labels.astype(np.int32, copy=False),
    )


def parse_feedback_json(obj) -> tuple[np.ndarray, np.ndarray]:
    """JSON feedback body -> ((n, H) float32, (n,) int32).

    ``{"image": [...], "label": 3}`` is the single form; ``{"images":
    [[...], ...], "labels": [...]}`` the batch form.  Labels must be
    integral — 400, not silent truncation, on ``2.5``.
    """
    if not isinstance(obj, dict) or ("image" in obj) == ("images" in obj):
        raise ValueError(
            'feedback body must be {"image": [...], "label": k} or '
            '{"images": [[...], ...], "labels": [...]}'
        )
    single = "image" in obj
    if single != ("label" in obj) or (not single) != ("labels" in obj):
        raise ValueError('pair "image" with "label" and "images" with "labels"')
    images = np.asarray(obj["image"] if single else obj["images"], np.float32)
    if single:
        if images.ndim != 1:
            raise ValueError(f'"image" must be a flat (H,) list, got {images.shape}')
        images = images[None]
    elif images.ndim != 2 or images.shape[0] == 0:
        raise ValueError(
            f'"images" must be a non-empty (n, H) list of lists, got {images.shape}'
        )
    raw = np.asarray([obj["label"]] if single else obj["labels"])
    if raw.dtype.kind == "f" and not np.equal(raw, np.floor(raw)).all():
        raise ValueError("labels must be integers")
    if raw.dtype.kind not in "iuf" or raw.shape != (len(images),):
        raise ValueError(
            f"labels must be ({len(images)},) integers, got "
            f"{raw.dtype}{raw.shape}"
        )
    return images, raw.astype(np.int32)


def parse_predict_json(obj) -> tuple[np.ndarray, bool]:
    """JSON predict body -> ((n, H) float32, was_single).

    ``{"image": [...]}`` is the single-request form (response carries
    ``"label"``); ``{"images": [[...], ...]}`` is the batch form
    (response carries ``"labels"``).  Anything else is a 400.
    """
    if not isinstance(obj, dict) or ("image" in obj) == ("images" in obj):
        raise ValueError(
            'predict body must be {"image": [...]} or {"images": [[...], ...]}'
        )
    single = "image" in obj
    arr = np.asarray(obj["image"] if single else obj["images"], np.float32)
    if single:
        if arr.ndim != 1:
            raise ValueError(f'"image" must be a flat (H,) list, got {arr.shape}')
        arr = arr[None]
    elif arr.ndim != 2 or arr.shape[0] == 0:
        raise ValueError(
            f'"images" must be a non-empty (n, H) list of lists, got {arr.shape}'
        )
    return arr, single


def parse_k(value) -> int:
    """Validate a requested k (JSON field or ``?k=`` query param) -> int.

    Must be an integer >= 1 — ``2.5`` is a 400, not a truncation.  The
    upper bound (the served store's row count) is the server's to
    enforce; it knows the model.
    """
    if isinstance(value, bool) or (
        isinstance(value, float) and value != int(value)
    ):
        raise ValueError(f'"k" must be a positive integer, got {value!r}')
    try:
        k = int(value)
    except (TypeError, ValueError):
        raise ValueError(f'"k" must be a positive integer, got {value!r}') from None
    if k < 1:
        raise ValueError(f'"k" must be >= 1, got {k}')
    return k


def parse_search_json(obj) -> tuple[np.ndarray, int, bool]:
    """JSON search body -> ((n, H) float32 queries, k, was_single).

    ``{"query": [...]}`` is the single form (response carries flat
    ``"indices"``/``"distances"``); ``{"queries": [[...], ...]}`` the
    batch form (nested lists).  ``"k"`` is optional and defaults to 1.
    """
    if not isinstance(obj, dict) or ("query" in obj) == ("queries" in obj):
        raise ValueError(
            'search body must be {"query": [...], "k": 5} or '
            '{"queries": [[...], ...], "k": 5}'
        )
    single = "query" in obj
    arr = np.asarray(obj["query"] if single else obj["queries"], np.float32)
    if single:
        if arr.ndim != 1:
            raise ValueError(f'"query" must be a flat (H,) list, got {arr.shape}')
        arr = arr[None]
    elif arr.ndim != 2 or arr.shape[0] == 0:
        raise ValueError(
            f'"queries" must be a non-empty (n, H) list of lists, got {arr.shape}'
        )
    return arr, parse_k(obj.get("k", 1)), single


def encode_search_result(indices, distances) -> bytes:
    """((n, k) indices, (n, k) distances) -> raw bytes: the C-order LE
    int32 indices block followed by the distances block, no framing."""
    idx = np.ascontiguousarray(np.asarray(indices, _I32))
    dist = np.ascontiguousarray(np.asarray(distances, _I32))
    if idx.ndim != 2 or idx.shape != dist.shape:
        raise ValueError(
            f"indices/distances must share one (n, k) shape, got "
            f"{idx.shape} and {dist.shape}"
        )
    return idx.tobytes() + dist.tobytes()


def decode_search_result(body: bytes, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Raw search response bytes -> ((n, k) int32 indices, (n, k) int32
    distances); loud on any length mismatch (each query row costs
    exactly ``8k`` bytes)."""
    row_bytes = 2 * k * _I32.itemsize
    if k < 1 or len(body) == 0 or len(body) % row_bytes != 0:
        raise ValueError(
            f"binary search payload of {len(body)} bytes is not a positive "
            f"multiple of {row_bytes} (= 2 * {k} int32 per query)"
        )
    n = len(body) // row_bytes
    split = n * k * _I32.itemsize
    indices = np.frombuffer(body[:split], _I32).reshape(n, k)
    distances = np.frombuffer(body[split:], _I32).reshape(n, k)
    return (
        indices.astype(np.int32, copy=False),
        distances.astype(np.int32, copy=False),
    )
