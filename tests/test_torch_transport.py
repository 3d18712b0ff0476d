"""The port's network front-end (``repro_torch.transport``: protocol,
client, server, watcher; ``launch.serve_http``) against the JAX package's.

* Every codec and parser of ``protocol`` gives the JAX copy's bytes,
  arrays and ``ValueError`` messages, malformed forms included.
* A JAX `HdcHttpServer` over a JAX registry and the port's over a port
  registry, both on one checkpoint that JAX wrote, answer one scripted
  request list identically: status, content type, echoed request id, and
  body bytes (or, where a body holds timings, its keys).
* Each package's `HdcClient` drives the other's server.
* The watcher promotes, restarts, survives poll errors, and never drops
  queued requests; ``serve_http --smoke --device cpu`` prints the JAX
  launcher's accuracy.

No test asserts a wall-clock bound that a loaded run can miss; every
wait polls with a timeout, and every server, registry and watcher is
stopped in a fixture.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import HDCConfig, HDCModel
from repro_torch.launch import serve_http as tserve_http
from repro_torch.serving import ModelRegistry, ServingEngine
from repro_torch.transport import (
    HdcClient,
    HdcHttpServer,
    OverloadedError,
    ReloadWatcher,
    TransportError,
    protocol,
)
from repro_torch.transport import server as tserver_mod

jax = pytest.importorskip("jax")
from repro.core import HDCConfig as JConfig  # noqa: E402
from repro.core import HDCModel as JModel  # noqa: E402
from repro.launch import serve_http as jserve_http  # noqa: E402
from repro.serving import ModelRegistry as JRegistry  # noqa: E402
from repro.transport import HdcClient as JClient  # noqa: E402
from repro.transport import HdcHttpServer as JServer  # noqa: E402
from repro.transport import protocol as jprotocol  # noqa: E402

N_FEATURES, N_CLASSES = 24, 4


def _kw(**over):
    kw = dict(n_features=N_FEATURES, n_classes=N_CLASSES, d=128, levels=16,
              similarity="hamming")
    kw.update(over)
    return kw


def _data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (n, N_FEATURES)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, n).astype(np.int32)
    return x, y


def _wait(cond, timeout_s: float = 60.0, poll_s: float = 0.005) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met within the timeout")
        time.sleep(poll_s)


@pytest.fixture
def owned():
    """Clients, servers, watchers and registries of either package, each
    closed or stopped (servers before registries) when the test ends."""
    objs: list = []
    yield objs.append
    for obj in objs:
        if hasattr(obj, "close") and not hasattr(obj, "shutdown"):
            obj.close()
    for obj in objs:
        if hasattr(obj, "_route"):  # an HTTP server of either package
            obj.stop(drain=False, timeout_s=30.0)
    for obj in objs:
        if hasattr(obj, "shutdown"):
            obj.shutdown(drain=False)
        elif hasattr(obj, "poll_once"):
            obj.stop()


# ---------------------------------------------------------------------------
# protocol: the same bytes, arrays and messages as the JAX copy
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(5)
_IMGS = _RNG.uniform(0, 255, (3, 5)).astype(np.float32)
_LABS = np.asarray([2, 0, 3], np.int32)
_IDX = _RNG.integers(0, 9, (3, 2)).astype(np.int32)
_DIST = _RNG.integers(0, 99, (3, 2)).astype(np.int32)

PROTOCOL_CASES = {
    "encode_images_2d": lambda p: p.encode_images(_IMGS),
    "encode_images_1d": lambda p: p.encode_images(_IMGS[0]),
    "encode_images_3d": lambda p: p.encode_images(_IMGS[None]),
    "decode_images": lambda p: p.decode_images(p.encode_images(_IMGS), 5),
    "decode_images_misaligned": lambda p: p.decode_images(b"\0" * 21, 5),
    "decode_images_empty": lambda p: p.decode_images(b"", 5),
    "encode_labels": lambda p: p.encode_labels(_LABS),
    "decode_labels": lambda p: p.decode_labels(p.encode_labels(_LABS)),
    "decode_labels_misaligned": lambda p: p.decode_labels(b"\0" * 7),
    "encode_feedback": lambda p: p.encode_feedback(_IMGS, _LABS),
    "encode_feedback_1d": lambda p: p.encode_feedback(_IMGS[0], [1]),
    "encode_feedback_bad_labels": lambda p: p.encode_feedback(_IMGS, [1, 2]),
    "decode_feedback": lambda p: p.decode_feedback(p.encode_feedback(_IMGS, _LABS), 5),
    "decode_feedback_misaligned": lambda p: p.decode_feedback(b"\0" * 25, 5),
    "feedback_json_single": lambda p: p.parse_feedback_json(
        {"image": _IMGS[0].tolist(), "label": 3}),
    "feedback_json_batch": lambda p: p.parse_feedback_json(
        {"images": _IMGS.tolist(), "labels": [1, 2.0, 0]}),
    "feedback_json_neither": lambda p: p.parse_feedback_json({"x": 1}),
    "feedback_json_unpaired": lambda p: p.parse_feedback_json(
        {"image": [1.0], "labels": [1]}),
    "feedback_json_fractional": lambda p: p.parse_feedback_json(
        {"images": _IMGS.tolist(), "labels": [1, 2.5, 0]}),
    "feedback_json_label_count": lambda p: p.parse_feedback_json(
        {"images": _IMGS.tolist(), "labels": [1, 2]}),
    "feedback_json_nested_image": lambda p: p.parse_feedback_json(
        {"image": _IMGS.tolist(), "label": 1}),
    "feedback_json_empty_batch": lambda p: p.parse_feedback_json(
        {"images": [], "labels": []}),
    "feedback_json_string_labels": lambda p: p.parse_feedback_json(
        {"images": _IMGS.tolist(), "labels": ["a", "b", "c"]}),
    "predict_json_single": lambda p: p.parse_predict_json({"image": _IMGS[0].tolist()}),
    "predict_json_batch": lambda p: p.parse_predict_json({"images": _IMGS.tolist()}),
    "predict_json_both": lambda p: p.parse_predict_json({"image": [1], "images": [[1]]}),
    "predict_json_list": lambda p: p.parse_predict_json([1, 2]),
    "predict_json_nested_single": lambda p: p.parse_predict_json({"image": [[1.0]]}),
    "predict_json_flat_batch": lambda p: p.parse_predict_json({"images": [1.0, 2.0]}),
    "predict_json_null_entry": lambda p: p.parse_predict_json({"image": [1.0, None]}),
    "predict_json_string_entry": lambda p: p.parse_predict_json({"image": [1.0, "x"]}),
    "parse_k_int": lambda p: p.parse_k(3),
    "parse_k_str": lambda p: p.parse_k("7"),
    "parse_k_integral_float": lambda p: p.parse_k(2.0),
    "parse_k_fraction": lambda p: p.parse_k(2.5),
    "parse_k_bool": lambda p: p.parse_k(True),
    "parse_k_zero": lambda p: p.parse_k(0),
    "parse_k_word": lambda p: p.parse_k("many"),
    "parse_k_none": lambda p: p.parse_k(None),
    "search_json_single": lambda p: p.parse_search_json({"query": _IMGS[0].tolist(), "k": 2}),
    "search_json_batch_default_k": lambda p: p.parse_search_json({"queries": _IMGS.tolist()}),
    "search_json_neither": lambda p: p.parse_search_json({"k": 2}),
    "search_json_bad_k": lambda p: p.parse_search_json({"queries": _IMGS.tolist(), "k": -1}),
    "search_json_empty": lambda p: p.parse_search_json({"queries": []}),
    "encode_search_result": lambda p: p.encode_search_result(_IDX, _DIST),
    "encode_search_result_shapes": lambda p: p.encode_search_result(_IDX, _DIST[:, :1]),
    "decode_search_result": lambda p: p.decode_search_result(
        p.encode_search_result(_IDX, _DIST), 2),
    "decode_search_result_misaligned": lambda p: p.decode_search_result(b"\0" * 12, 2),
    "decode_search_result_k0": lambda p: p.decode_search_result(b"\0" * 16, 0),
    "sanitize_json": lambda p: p.sanitize_json(
        {"a": float("nan"), "b": [1.0, float("inf"), {"c": -float("inf")}], "d": (2, "x")}),
    "paths": lambda p: (p.predict_path("m"), p.search_path("m"), p.feedback_path("m")),
    "constants": lambda p: (p.CT_JSON, p.CT_F32, p.CT_I32, p.CT_PROM, p.ROUTE_HEALTH,
                            p.ROUTE_MODELS, p.ROUTE_METRICS, p.ROUTE_TRACES, p.ROUTE_FLEET,
                            p.ROUTE_PROFILE, p.HDR_REQUEST_ID, p.METRICS_DETAIL_STATE),
}


def _outcome(fn, mod):
    try:
        out = fn(mod)
    except Exception as e:  # the type and message are part of the contract
        return ("raised", type(e).__name__, str(e))
    return ("returned", out)


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", sorted(PROTOCOL_CASES))
def test_protocol_equals_jax(case):
    fn = PROTOCOL_CASES[case]
    got, want = _outcome(fn, protocol), _outcome(fn, jprotocol)
    assert _same(got, want), (got, want)


# ---------------------------------------------------------------------------
# the scripted request list against both servers
# ---------------------------------------------------------------------------

MAX_BODY = 4096


@pytest.fixture
def both(tmp_path, owned):
    """A JAX and a port server, each over a registry of three entries on one
    checkpoint that JAX wrote: "m" (serving), "held" (a batcher that was
    never started, at max_depth=2 with 2 requests queued) and "stopped"."""
    x, y = _data(0, 48)
    JModel.create(JConfig(**_kw())).fit(x, y).save(tmp_path / "ckpt", step=0)
    q = _data(1, 2)[0]
    servers = {}
    for pkg, reg_cls, srv_cls, extra in (
        ("jax", JRegistry, JServer, {}),
        ("port", ModelRegistry, HdcHttpServer, {"devices": ["cpu"]}),
    ):
        registry = reg_cls()
        owned(registry)
        for name, start, depth in (("m", True, None), ("held", False, 2), ("stopped", True, None)):
            registry.register_checkpoint(name, tmp_path / "ckpt", step=0, batch_size=8,
                                         start=start, max_depth=depth, max_delay_ms=1.0,
                                         **extra)
        for img in q:
            registry.submit("held", img)
        registry.batcher("stopped").stop()
        server = srv_cls(registry, max_body_bytes=MAX_BODY).start()
        owned(server)
        servers[pkg] = server
    return servers


def _request(address, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*address, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return (resp.status, resp.headers.get("Content-Type"),
                resp.headers.get(protocol.HDR_REQUEST_ID), resp.read())
    finally:
        conn.close()


def _keys(obj):
    """The nested key structure of a JSON value (lists by their first item)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__ if obj is None or isinstance(obj, (bool, str)) else "number"


_Q = _data(2, 5)[0]
_F32 = {"Content-Type": protocol.CT_F32}
_RAW = {"Content-Type": protocol.CT_F32, "Accept": protocol.CT_I32}
_JSON = {"Content-Type": protocol.CT_JSON}


def _rid(i):
    return {protocol.HDR_REQUEST_ID: f"req-script-{i}"}


def _js(obj) -> bytes:
    return json.dumps(obj).encode()


# (label, method, path, body, headers, compare): compare is "bytes" (status,
# content type, echoed id and body bytes equal) or "keys" (the JSON body's key
# structure equal; the values hold timings)
SCRIPT = [
    ("healthz", "GET", "/healthz", None, {}, "bytes"),
    ("models", "GET", "/v1/models", None, {}, "keys_models"),
    ("metrics_state", "GET", "/metrics?detail=state", None, {}, "keys"),
    ("predict_json_single", "POST", "/v1/models/m:predict",
     _js({"image": _Q[0].tolist()}), {**_JSON, **_rid(0)}, "bytes"),
    ("predict_json_batch", "POST", "/v1/models/m:predict",
     _js({"images": _Q.tolist()}), {**_JSON, **_rid(1)}, "bytes"),
    ("predict_raw_batch", "POST", "/v1/models/m:predict", _Q.tobytes(),
     {**_RAW, **_rid(2)}, "bytes"),
    ("predict_raw_json_reply", "POST", "/v1/models/m:predict", _Q.tobytes(),
     {**_F32, **_rid(3)}, "bytes"),
    ("predict_hostile_id", "POST", "/v1/models/m:predict", _Q[:1].tobytes(),
     {**_RAW, protocol.HDR_REQUEST_ID: "bad id\x7f"}, "status"),
    ("search_raw_k3", "POST", "/v1/models/m:search?k=3", _Q.tobytes(),
     {**_RAW, **_rid(4)}, "bytes"),
    ("search_raw_k1", "POST", "/v1/models/m:search?k=1", _Q.tobytes(),
     {**_RAW, **_rid(5)}, "bytes"),
    ("search_json_single", "POST", "/v1/models/m:search",
     _js({"query": _Q[0].tolist(), "k": 2}), {**_JSON, **_rid(6)}, "bytes"),
    ("search_json_batch_k1", "POST", "/v1/models/m:search",
     _js({"queries": _Q.tolist(), "k": 1}), {**_JSON, **_rid(7)}, "bytes"),
    ("404_model", "POST", "/v1/models/nope:predict", _js({"image": [1.0]}), _JSON, "bytes"),
    ("404_search_model", "POST", "/v1/models/nope:search", _js({"query": [1.0]}), _JSON,
     "bytes"),
    ("404_route", "GET", "/v2/nothing", None, {}, "bytes"),
    ("405_predict", "GET", "/v1/models/m:predict", None, {}, "bytes"),
    ("405_search", "GET", "/v1/models/m:search", None, {}, "bytes"),
    ("405_feedback", "GET", "/v1/models/m:feedback", None, {}, "bytes"),
    ("405_profile", "GET", "/v1/debug/profile", None, {}, "bytes"),
    ("400_features", "POST", "/v1/models/m:predict", _js({"images": [[1.0] * 7]}), _JSON,
     "bytes"),
    ("400_misaligned", "POST", "/v1/models/m:predict", b"\0" * 28, _F32, "bytes"),
    ("400_not_json", "POST", "/v1/models/m:predict", b"not json", _JSON, "bytes"),
    ("400_non_numeric", "POST", "/v1/models/m:predict",
     _js({"image": [1.0, None] + [0.0] * (N_FEATURES - 2)}), _JSON, "bytes"),
    ("400_non_numeric_object", "POST", "/v1/models/m:predict",
     _js({"image": [1.0, {"a": 1}] + [0.0] * (N_FEATURES - 2)}), _JSON, "bytes"),
    ("400_search_k0", "POST", "/v1/models/m:search?k=0", _Q.tobytes(), _RAW, "bytes"),
    ("400_search_k_fraction", "POST", "/v1/models/m:search",
     _js({"queries": _Q.tolist(), "k": 2.5}), _JSON, "bytes"),
    ("400_search_k_too_big", "POST", "/v1/models/m:search?k=5", _Q.tobytes(), _RAW, "bytes"),
    ("400_search_features", "POST", "/v1/models/m:search", _js({"query": [1.0]}), _JSON,
     "bytes"),
    ("413", "POST", "/v1/models/m:predict", b"\0" * (MAX_BODY + 4), _RAW, "bytes"),
    ("415", "POST", "/v1/models/m:predict", b"x", {"Content-Type": "text/plain"}, "bytes"),
    ("415_search", "POST", "/v1/models/m:search", b"x", {"Content-Type": "text/csv"},
     "bytes"),
    ("429", "POST", "/v1/models/held:predict", _Q[:1].tobytes(), _RAW, "bytes"),
    ("429_search", "POST", "/v1/models/held:search?k=1", _Q[:1].tobytes(), _RAW, "bytes"),
    ("503", "POST", "/v1/models/stopped:predict", _Q[:1].tobytes(), _RAW, "bytes"),
    ("503_search", "POST", "/v1/models/stopped:search?k=2", _Q[:1].tobytes(), _RAW,
     "bytes"),
    ("feedback_404_no_learner", "POST", "/v1/models/m:feedback",
     protocol.encode_feedback(_Q[:2], [0, 1]), _F32, "bytes"),
    ("feedback_404_model", "POST", "/v1/models/nope:feedback",
     protocol.encode_feedback(_Q[:2], [0, 1]), _F32, "bytes"),
    ("profile_403", "POST", "/v1/debug/profile?ms=5", b"", {}, "bytes"),
    ("traces_n_400", "GET", "/v1/traces?n=x", None, {}, "bytes"),
    ("traces_kind_400", "GET", "/v1/traces?kind=bogus", None, {}, "bytes"),
    ("traces_id_404", "GET", "/v1/traces?id=req-none", None, {}, "bytes"),
    ("traces_id_hit", "GET", "/v1/traces?id=req-script-0", None, {}, "keys"),
    ("metrics_json", "GET", "/metrics", None, {}, "keys"),
    ("healthz_after", "GET", "/healthz", None, {}, "bytes"),
]


def test_servers_answer_the_scripted_requests_identically(both):
    """One request list, in order, against each server: the same status,
    content type, echoed id and body bytes (or JSON keys)."""
    answers = {}
    for pkg, server in both.items():
        answers[pkg] = [_request(server.address, m, p, b, h) for _, m, p, b, h, _ in SCRIPT]
    for (label, *_, compare), got, want in zip(SCRIPT, answers["port"], answers["jax"]):
        assert got[:3] == want[:3], (label, got, want)
        if compare == "bytes":
            assert got[3] == want[3], (label, got[3], want[3])
        elif compare in ("keys", "keys_models"):
            g, w = json.loads(got[3]), json.loads(want[3])
            if compare == "keys":
                assert _keys(g) == _keys(w), label
            else:  # engines describe themselves per package; the shared facts agree
                assert g["models"].keys() == w["models"].keys()
                for name in g["models"]:
                    for key in ("encoder", "d", "n_classes", "placement", "batch_size",
                                "step", "n_seen", "packed_bytes", "codebook_bytes"):
                        assert g["models"][name][key] == w["models"][name][key], (name, key)
    labels = dict(zip([s[0] for s in SCRIPT], answers["port"]))
    # the raw replies decode as predict would, and k=1 search is predict
    pred = protocol.decode_labels(labels["predict_raw_batch"][3])
    idx, _ = protocol.decode_search_result(labels["search_raw_k1"][3], 1)
    idx3, dist3 = protocol.decode_search_result(labels["search_raw_k3"][3], 3)
    assert np.array_equal(idx[:, 0], pred) and np.array_equal(idx3[:, 0], pred)
    assert (np.diff(dist3, axis=1) >= 0).all()
    assert json.loads(labels["search_json_batch_k1"][3])["indices"] == [[int(v)] for v in pred]
    # the hostile id was replaced by a minted one on both sides, not echoed
    assert labels["predict_hostile_id"][2].startswith("req-")
    # the same requests reached the same counters
    state = {pkg: json.loads(_request(s.address, "GET", "/metrics?detail=state")[3])
             for pkg, s in both.items()}
    for name in ("m", "held", "stopped"):
        assert state["port"][name]["serving"]["counters"] == \
            state["jax"][name]["serving"]["counters"], name
        assert state["port"][name]["serving"]["latency"]["count"] == \
            state["jax"][name]["serving"]["latency"]["count"]


def test_prometheus_families_equal_jax(both):
    """The same families, HELP and TYPE lines from either server."""
    texts = {pkg: _request(s.address, "GET", "/metrics", headers={"Accept": "text/plain"})
             for pkg, s in both.items()}
    assert texts["port"][:2] == texts["jax"][:2]

    def meta(text):
        return [line for line in text.decode().splitlines() if line.startswith("#")]

    assert meta(texts["port"][3]) == meta(texts["jax"][3])


def test_crossed_clients(both):
    """The port's client against the JAX server and the JAX client against
    the port's: the same labels, search results, states and traces."""
    q = _data(3, 6)[0]
    results = {}
    for client_pkg, cls in (("port", HdcClient), ("jax", JClient)):
        for server_pkg, server in both.items():
            with cls(*server.address) as c:
                out = {
                    "health": c.healthz()["models"]["m"]["step"],
                    "models": sorted(c.models()),
                    "single": c.predict("m", q[0], request_id=f"req-x-{client_pkg}"),
                    "binary": c.predict_batch("m", q).tolist(),
                    "json": c.predict_batch("m", q, binary=False).tolist(),
                    "search": [a.tolist() for a in c.search("m", q, k=2)],
                    "search_json": [a.tolist() for a in c.search("m", q, k=2, binary=False)],
                    "state_keys": sorted(c.metrics_state()),
                    "trace": c.traces(request_id=f"req-x-{client_pkg}")[0]["id"],
                }
                # each package raises its own TransportError / OverloadedError
                with pytest.raises(RuntimeError) as e:
                    c.predict_batch("held", q[:1])
                out["shed"] = (e.value.status, type(e.value).__name__)
                with pytest.raises(RuntimeError) as e:
                    c.feedback("m", q[:1], [0])
                out["feedback"] = (e.value.status, type(e.value).__name__)
                assert c.last_request_id is not None
            results[client_pkg, server_pkg] = out
    want = results["jax", "jax"]
    for key, got in results.items():
        assert {k: v for k, v in got.items() if k != "trace"} == \
            {k: v for k, v in want.items() if k != "trace"}, key
        assert got["trace"] == f"req-x-{key[0]}"


def test_profile_route_through_the_port_profiler(both, monkeypatch):
    """Enabled: the capture runs through `obs.profiler.profile_capture` (a
    module attribute the test stubs); 409 while another capture runs;
    400 on a bad window."""
    server = HdcHttpServer(both["port"].registry, enable_profiling=True).start()
    calls = []

    def fake_capture(out_dir, ms):
        calls.append(ms)
        if len(calls) == 2:
            raise RuntimeError("a profile capture is already in progress")
        return out_dir

    monkeypatch.setattr(tserver_mod._profiler, "profile_capture", fake_capture)
    try:
        st, ct, _, body = _request(server.address, "POST", "/v1/debug/profile?ms=7")
        assert st == 200 and json.loads(body)["ms"] == 7.0
        st, _, _, body = _request(server.address, "POST", "/v1/debug/profile?ms=7")
        assert st == 409 and "already in progress" in json.loads(body)["error"]
        for bad in ("x", "0", "60001"):
            assert _request(server.address, "POST", f"/v1/debug/profile?ms={bad}")[0] == 400
    finally:
        server.stop()
    assert calls == [7.0, 7.0]


# ---------------------------------------------------------------------------
# the port's server: shutdown, a handler bug, shedding, stopping
# ---------------------------------------------------------------------------


def _port_stack(owned, *, batch_size=8, start=True, max_depth=None, **server_kw):
    x, y = _data(4, 32)
    model = HDCModel.create(HDCConfig(**_kw()), device="cpu").fit(x, y)
    registry = ModelRegistry()
    owned(registry)
    batcher = registry.register("m", ServingEngine(model, batch_size=batch_size, device="cpu"),
                                start=start, max_delay_ms=1.0, max_depth=max_depth)
    server = HdcHttpServer(registry, **server_kw).start()
    owned(server)
    client = HdcClient(*server.address)
    owned(client)
    return model, registry, batcher, server, client


def test_server_drain_shutdown_returns_with_an_idle_keepalive_connection(owned):
    """An idle keep-alive connection is cancelled at once, so stop()
    returns long before its 120 s drain window: a hang would take 120 s,
    a loaded run far less than 30 (no tighter bound is asserted)."""
    _, registry, _, server, client = _port_stack(owned)
    assert client.predict("m", _data(5, 1)[0][0]) >= 0  # the socket stays open, idle
    t0 = time.monotonic()
    server.stop(timeout_s=120.0)
    assert time.monotonic() - t0 < 30.0
    server.stop()  # idempotent
    registry.shutdown()
    registry.shutdown()
    assert registry.names() == ()


def test_server_answers_500_on_handler_bug(owned):
    _, registry, _, _, client = _port_stack(owned)

    def boom():
        raise RuntimeError("handler fell over")

    registry.names = boom
    with pytest.raises(TransportError, match="handler fell over") as e:
        client.healthz()
    assert e.value.status == 500
    del registry.names
    assert client.healthz()["status"] == "ok"  # the connection survived


def test_http_sheds_on_bounded_queue(owned):
    _, registry, batcher, _, client = _port_stack(owned, start=False, max_depth=2)
    q = _data(6, 4)[0]
    fut = registry.submit("m", q[0])
    with pytest.raises(OverloadedError) as e:
        client.predict_batch("m", q[1:])
    assert e.value.status == 429
    batcher.submit(q[1])
    with pytest.raises(OverloadedError):
        client.predict("m", q[2])
    snap = client.metrics()["m"]
    assert snap["n_shed"] >= 4 and snap["queue_depth"] == 2
    batcher.flush()
    assert isinstance(fut.result(timeout=0), int)


def test_http_rejects_when_batcher_stopped(owned):
    _, registry, batcher, _, client = _port_stack(owned)
    batcher.stop()
    with pytest.raises(TransportError, match="stopped") as e:
        client.predict("m", _data(7, 1)[0][0])
    assert e.value.status == 503
    assert client.metrics()["m"]["n_rejected"] >= 1


def test_http_labels_equal_the_engine_and_trace_spans(owned):
    model, registry, batcher, _, client = _port_stack(owned)
    q = _data(8, 12)[0]
    direct = registry.engine("m").predict(q)
    assert np.array_equal(client.predict_batch("m", q), direct)
    assert np.array_equal(client.predict_batch("m", q, binary=False), direct)
    assert [client.predict("m", img) for img in q[:3]] == direct[:3].tolist()
    _wait(lambda: batcher.metrics.stage["write"].count == 12 + 12 + 3)
    entries = [t for t in client.traces(kind="request") if t["id"].startswith("cli-")]
    assert len(entries) == 27
    for t in entries:
        assert set(t["spans"]) == {"queue_ms", "assembly_ms", "device_ms", "write_ms"}
        assert sum(t["spans"].values()) <= t["e2e_ms"] + 1e-6


# ---------------------------------------------------------------------------
# the client's retry on a stale keep-alive socket
# ---------------------------------------------------------------------------


def _canned(status: int, phrase: str, body: dict) -> bytes:
    payload = json.dumps(body).encode()
    return (f"HTTP/1.1 {status} {phrase}\r\nContent-Type: {protocol.CT_JSON}\r\n"
            f"Content-Length: {len(payload)}\r\nConnection: keep-alive\r\n\r\n"
            ).encode() + payload


class _ScriptedServer:
    """A listening socket answering each request from a script: canned
    bytes, or "close" (read the request, drop the connection)."""

    def __init__(self, script: list):
        import socket

        self._script = list(script)
        self.n_requests = 0
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.address = self._sock.getsockname()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while self._script:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn, conn.makefile("rb") as f:
                while self._script:
                    if not self._read_request(f):
                        break
                    self.n_requests += 1
                    action = self._script.pop(0)
                    if action == "close":
                        break
                    conn.sendall(action)

    @staticmethod
    def _read_request(f) -> bool:
        if not f.readline():
            return False
        length = 0
        while True:
            raw = f.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            key, _, value = raw.decode("latin-1").partition(":")
            if key.strip().lower() == "content-length":
                length = int(value)
        if length:
            f.read(length)
        return True

    def close(self):
        self._sock.close()
        self._thread.join(timeout=10.0)


@pytest.mark.parametrize("status,phrase,expect", [
    (413, "Payload Too Large", TransportError),
    (429, "Too Many Requests", OverloadedError),
    (503, "Service Unavailable", TransportError),
])
def test_client_does_not_retry_http_error_statuses(status, phrase, expect):
    server = _ScriptedServer([_canned(status, phrase, {"error": "nope"})])
    client = HdcClient(*server.address)
    try:
        with pytest.raises(expect, match="nope") as e:
            client.healthz()
        assert e.value.status == status and server.n_requests == 1
    finally:
        client.close()
        server.close()


def test_client_retries_once_on_stale_keepalive_socket():
    server = _ScriptedServer(["close", _canned(200, "OK", {"status": "ok"})])
    client = HdcClient(*server.address)
    try:
        assert client.healthz() == {"status": "ok"}
        assert server.n_requests == 2  # the dead socket's read + the retry
    finally:
        client.close()
        server.close()


def test_client_propagates_second_consecutive_connection_failure():
    server = _ScriptedServer(["close", "close"])
    client = HdcClient(*server.address)
    try:
        with pytest.raises((http.client.HTTPException, ConnectionError)):
            client.healthz()
        assert server.n_requests == 2
    finally:
        client.close()
        server.close()


# ---------------------------------------------------------------------------
# the reload watcher
# ---------------------------------------------------------------------------


def _ckpt(tmp_path, owned, **reg_kw):
    x, y = _data(9, 32)
    model = HDCModel.create(HDCConfig(**_kw()), device="cpu").fit(x, y)
    model.save(tmp_path / "ckpt", step=0)
    registry = ModelRegistry()
    owned(registry)
    batcher = registry.register_checkpoint("m", tmp_path / "ckpt", batch_size=4,
                                           devices=["cpu"], **reg_kw)
    return model, registry, batcher


def test_watcher_promotes_published_steps(tmp_path, owned):
    model, registry, _ = _ckpt(tmp_path, owned)
    watcher = ReloadWatcher(registry, "m", interval_s=0.02).start()
    owned(watcher)
    assert registry.watcher("m") is watcher
    with pytest.raises(ValueError, match="already has a watcher"):
        registry.attach_watcher("m", object())
    model.partial_fit(*_data(10, 16)).save(tmp_path / "ckpt", step=3)
    _wait(lambda: registry.engine("m").step == 3)
    assert watcher.n_promotions == 1 and watcher.last_step == 3
    assert watcher.describe()["running"]
    (event,) = [e for e in registry.traces.snapshot(kind="event")]
    assert event["event"] == "promotion" and event["step"] == 3
    registry.shutdown()
    assert not watcher.running()
    watcher.stop()  # idempotent


def test_watcher_restarts_after_stop(tmp_path, owned):
    model, registry, _ = _ckpt(tmp_path, owned)
    watcher = ReloadWatcher(registry, "m", interval_s=0.02).start()
    owned(watcher)
    watcher.stop()
    assert not watcher.running()
    watcher.start()
    assert watcher.running() and registry.watcher("m") is watcher
    model.partial_fit(*_data(11, 16)).save(tmp_path / "ckpt", step=1)
    _wait(lambda: registry.engine("m").step == 1)


def test_watcher_attach_requires_registered_entry():
    with pytest.raises(KeyError, match="unknown model"):
        ReloadWatcher(ModelRegistry(), "ghost").start()


def test_watcher_survives_poll_errors(tmp_path, owned):
    _, registry, _ = _ckpt(tmp_path, owned)
    watcher = ReloadWatcher(registry, "m", interval_s=0.02)
    bad = tmp_path / "ckpt" / "step_000000007"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps(
        {"step": 7, "leaves": [], "extra": {}, "time": 0.0}))
    assert watcher.poll_once() is None
    assert watcher.n_errors == 1 and watcher.last_error is not None
    assert registry.engine("m").step == 0  # still serving step 0
    assert watcher.n_polls == 1 and watcher.n_promotions == 0


def test_queued_requests_survive_watcher_triggered_reload(tmp_path, owned):
    """Queued futures are served by the promoted engine, none dropped; the
    promoted step is a JAX-package `convert` of the same state, so the
    labels equal the JAX model's too."""
    model, registry, batcher = _ckpt(tmp_path, owned)
    watcher = ReloadWatcher(registry, "m", interval_s=0.02).start()
    owned(watcher)
    q = _data(12, 6)[0]
    futures = batcher.submit_many(q)  # the drain was never started: the queue holds
    model.convert("uhd_dynamic").save(tmp_path / "ckpt", step=1)
    _wait(lambda: registry.engine("m").step == 1)
    assert batcher.queue_depth() == 6
    assert registry.engine("m").model.cfg.encoder == "uhd_dynamic"
    batcher.flush()
    got = np.asarray([f.result(timeout=0) for f in futures])
    assert np.array_equal(got, registry.engine("m").predict(q))
    jmodel = JModel.load(tmp_path / "ckpt", step=1)
    assert np.array_equal(got, np.asarray(jmodel.predict(q)))
    assert {f.trace.step for f in futures} == {1}
    assert batcher.metrics.n_reloads == 1 and watcher.n_errors == 0


def test_watcher_promotion_under_inflight_http_traffic(tmp_path, owned):
    model, registry, _ = _ckpt(tmp_path, owned, max_delay_ms=1.0, start=True)
    watcher = ReloadWatcher(registry, "m", interval_s=0.02).start()
    owned(watcher)
    server = HdcHttpServer(registry).start()
    owned(server)
    q = _data(13, 16)[0]
    expect = model.predict(q).numpy()
    stop = threading.Event()
    results: list[np.ndarray] = []

    def pound():
        with HdcClient(*server.address, timeout_s=60.0) as client:
            while not stop.is_set():
                results.append(client.predict_batch("m", q))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        workers = [pool.submit(pound) for _ in range(2)]
        try:
            _wait(lambda: len(results) >= 3)
            model.convert("uhd_dynamic").save(tmp_path / "ckpt", step=1)
            _wait(lambda: registry.engine("m").step == 1)
            n_at_swap = len(results)
            _wait(lambda: len(results) >= n_at_swap + 3)
        finally:
            stop.set()
        for w in workers:
            w.result(timeout=60.0)
    for got in results:
        assert np.array_equal(got, expect)
    assert watcher.n_promotions == 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_http_smoke_prints_the_jax_launchers_accuracy(capsys):
    args = ["--smoke", "--d", "256", "--n-train", "200", "--requests", "64",
            "--watch-interval", "0.05"]
    assert jserve_http.main(args) == 0
    want = capsys.readouterr().out
    assert tserve_http.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def accuracy(out):
        (line,) = [ln for ln in out.splitlines() if ln.startswith("served accuracy")]
        return line

    assert accuracy(got) == accuracy(want)
    assert "transport parity vs in-process engine: OK" in got
    assert "oversize payload -> 413 OK" in got and got.rstrip().endswith("smoke OK")


def test_serve_http_smoke_pool_of_two_replicas_on_the_cpu(capsys):
    args = ["--smoke", "--device", "cpu", "--d", "256", "--n-train", "200",
            "--requests", "64", "--replicas", "2",
            "--watch-interval", "0.05"]
    assert tserve_http.main(args) == 0
    out = capsys.readouterr().out
    assert "placement: pool x2 replicas" in out
    assert "all 2 replicas at step 1" in out and out.rstrip().endswith("smoke OK")
