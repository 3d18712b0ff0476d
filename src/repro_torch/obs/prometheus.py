"""Prometheus text exposition (format 0.0.4) for the serving registry.

The port's copy of ``repro.obs.prometheus``: for the same metrics the
text is byte-identical to the JAX package's.

`GET /metrics` with ``Accept: text/plain`` renders every registered
model's serving metrics, transport admission counters, watcher
promotion stats, and online-learner lag as ``uhd_*`` families —
counters end in ``_total``, histograms emit the full cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``, durations are in
seconds (Prometheus base units).  The JSON form of `/metrics` stays
the default, so nothing that scrapes the old endpoint breaks.

Escaping follows the text-format spec exactly: label values escape
``\\``, ``"`` and newline; HELP text escapes ``\\`` and newline (but
not quotes).  Each family carries ``# HELP``/``# TYPE`` exactly once,
however many label splits (per-stage, per-replica) feed it — the
`Writer` groups samples by family, and :func:`parse_exposition` (the
strict inverse, used by tests and federating scrapers) raises on any
duplicate header, so the invariant is machine-checked, not hoped for.

The building blocks (`Writer`, `serving_families`) are public: the
fleet aggregator renders its *merged* metrics through the same code
that renders a single process, so a dashboard cannot tell them apart.
"""

from __future__ import annotations

import math

from repro_torch.obs.histogram import LatencyHistogram

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape(value) -> str:
    """Label-value escaping: backslash, double-quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP-text escaping: backslash and newline only (per the spec,
    quotes are literal in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _num(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    f = float(value)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Writer:
    """Groups samples by family so HELP/TYPE headers are emitted once,
    whatever order (and under whatever label splits) samples arrive."""

    def __init__(self):
        self._families: dict[str, tuple[str, str, list[str]]] = {}

    def sample(self, name, labels, value, *, mtype="gauge", help=""):
        if value is None:
            return
        _, _, lines = self._families.setdefault(name, (mtype, help, []))
        lines.append(f"{name}{_labels(labels)} {_num(value)}")

    def histogram(self, name, labels, hist: LatencyHistogram, *, help=""):
        mtype, _, lines = self._families.setdefault(name, ("histogram", help, []))
        cumulative = hist.cumulative()
        for bound, cum in cumulative:
            le = "+Inf" if math.isinf(bound) else _num(bound)
            lines.append(f"{name}_bucket{_labels({**labels, 'le': le})} {cum}")
        lines.append(f"{name}_sum{_labels(labels)} {_num(hist.sum_s)}")
        lines.append(f"{name}_count{_labels(labels)} {cumulative[-1][1]}")

    def render(self) -> str:
        out = []
        for name, (mtype, help, lines) in self._families.items():
            if help:
                out.append(f"# HELP {name} {_escape_help(help)}")
            out.append(f"# TYPE {name} {mtype}")
            out.extend(lines)
        return "\n".join(out) + "\n"


# back-compat aliases (pre-aggregator internal names)
_Writer = Writer


def serving_families(w: Writer, labels: dict, m) -> None:
    """Emit the ``uhd_*`` serving families for one `ServingMetrics`
    under the given label set.  A single-engine entry passes
    ``{"model": name}`` (the historical label set, unchanged); a
    replica-pool entry calls this once per replica with an added
    ``replica="<i>"`` label plus once with ``replica="pool"`` for the
    pool's own admission counters — `sum by (model)` recovers the
    fleet totals exactly because histograms merge bucket-wise.  The
    fleet aggregator calls it once per model with the cross-target
    merged metrics."""
    counters = (
        ("uhd_requests_total", m.n_requests, "requests completed"),
        ("uhd_request_errors_total", m.n_errors, "requests failed"),
        ("uhd_batches_total", m.n_batches, "device batches launched"),
        ("uhd_slots_total", m.n_slots, "slots across launched batches"),
        ("uhd_padded_slots_total", m.n_padded, "padded (empty) slots"),
        ("uhd_shed_total", m.n_shed, "requests shed by admission control"),
        ("uhd_rejected_total", m.n_rejected,
         "requests rejected for non-load reasons"),
        ("uhd_reloads_total", m.n_reloads, "hot engine swaps"),
    )
    for fam, value, help in counters:
        w.sample(fam, labels, value, mtype="counter", help=help)
    w.sample("uhd_queue_depth", labels, m.queue_depth,
             help="requests currently queued")
    w.sample("uhd_inflight", labels, m.inflight,
             help="requests dequeued but not yet resolved")
    w.histogram("uhd_request_latency_seconds", labels, m.latency,
                help="end-to-end submit-to-resolve latency")
    for stage, hist in m.stage.items():
        w.histogram("uhd_stage_latency_seconds", {**labels, "stage": stage},
                    hist, help="per-stage request latency")


_serving_families = serving_families


def render_prometheus(registry) -> str:
    """Text exposition for one `ModelRegistry` (serving + transport
    admission + watcher + online learner, per model; per replica for
    pool entries)."""
    w = Writer()
    for name in registry.names():
        try:
            batcher = registry.batcher(name)
        except KeyError:  # racing an unregister
            continue
        labels = {"model": name}
        replicas = getattr(batcher, "replicas", None)
        if replicas is not None:  # ReplicaPool: per-replica + admission
            serving_families(w, {**labels, "replica": "pool"}, batcher.metrics)
            for i, r in enumerate(replicas):
                serving_families(w, {**labels, "replica": str(i)}, r.metrics)
        else:
            serving_families(w, labels, batcher.metrics)

        watcher = registry.watcher(name)
        if watcher is not None:
            for fam, attr, help in (
                ("uhd_watcher_polls_total", "n_polls", "checkpoint polls"),
                ("uhd_watcher_promotions_total", "n_promotions",
                 "checkpoints promoted into serving"),
                ("uhd_watcher_errors_total", "n_errors", "failed poll/promote cycles"),
            ):
                w.sample(fam, labels, getattr(watcher, attr, None),
                         mtype="counter", help=help)
            w.sample("uhd_watcher_last_step", labels,
                     getattr(watcher, "last_step", None),
                     help="last promoted checkpoint step")
            hist = getattr(watcher, "promote_hist", None)
            if isinstance(hist, LatencyHistogram):
                w.histogram("uhd_watcher_promote_seconds", labels, hist,
                            help="reload-to-serve promotion latency "
                                 "(load + warm + swap)")

        learner = registry.learner(name)
        if learner is not None:
            snap = learner.snapshot()
            for fam, key, help in (
                ("uhd_online_ingested_total", "n_ingested", "feedback examples accepted"),
                ("uhd_online_trained_total", "n_trained", "feedback examples trained"),
                ("uhd_online_shed_total", "n_shed", "feedback blocks shed"),
                ("uhd_online_published_total", "n_published", "checkpoints published"),
                ("uhd_online_errors_total", "n_errors", "learner errors"),
            ):
                w.sample(fam, labels, snap.get(key), mtype="counter", help=help)
            w.sample("uhd_online_buffered", labels, snap.get("buffered"),
                     help="feedback examples waiting in the buffer")
            w.sample("uhd_online_lag_examples", labels, snap.get("lag_examples"),
                     help="ingested-but-untrained examples")
            w.sample("uhd_online_staleness_seconds", labels,
                     snap.get("staleness_s"),
                     help="age of unpublished training progress")
            hist = getattr(learner, "publish_hist", None)
            if isinstance(hist, LatencyHistogram):
                w.histogram("uhd_online_publish_seconds", labels, hist,
                            help="checkpoint publish (save) latency")
            # online-path stage instrumentation (ingest/train/publish)
            metrics = getattr(learner, "metrics", None)
            if metrics is not None:
                w.histogram("uhd_online_feedback_to_publish_seconds", labels,
                            metrics.latency,
                            help="oldest-feedback-to-checkpoint-publish "
                                 "latency per publish cycle")
                for stage, hist in metrics.stage.items():
                    w.histogram("uhd_online_stage_latency_seconds",
                                {**labels, "stage": stage}, hist,
                                help="per-stage online-learning latency")
    return w.render()


# -- parsing (the strict inverse; tests + federating scrapers) --------------


def _unescape_label(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_label_block(block: str, line: str) -> dict[str, str]:
    """``k1="v1",k2="v2"`` -> dict, honoring escaped quotes/commas."""
    labels: dict[str, str] = {}
    i = 0
    while i < len(block):
        eq = block.find("=", i)
        if eq < 0 or i + 1 > eq:
            raise ValueError(f"malformed labels in line {line!r}")
        key = block[i:eq].strip()
        if eq + 1 >= len(block) or block[eq + 1] != '"':
            raise ValueError(f"unquoted label value in line {line!r}")
        j = eq + 2
        raw = []
        while j < len(block):
            c = block[j]
            if c == "\\":
                if j + 1 >= len(block):
                    raise ValueError(f"dangling escape in line {line!r}")
                raw.append(block[j : j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        else:
            raise ValueError(f"unterminated label value in line {line!r}")
        labels[key] = _unescape_label("".join(raw))
        i = j + 1
        if i < len(block):
            if block[i] != ",":
                raise ValueError(f"malformed label separator in line {line!r}")
            i += 1
    return labels


def parse_exposition(text: str):
    """Strict parse of text format 0.0.4 -> ``(types, helps, samples)``.

    ``types``/``helps`` map family name to its TYPE/HELP (unescaped);
    ``samples`` is ``[(name, labels_dict, value_float)]`` in document
    order with label values fully unescaped.  Raises ValueError on a
    duplicate HELP or TYPE for a family, a malformed label block, or a
    non-numeric value — the parser is the audit: if the exposition
    survives it, every family header is unique and every hostile label
    value round-trips.
    """
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    samples: list[tuple[str, dict[str, str], float]] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line {line!r}")
            fam, mtype = parts[2], parts[3]
            if fam in types:
                raise ValueError(f"duplicate TYPE for family {fam!r}")
            types[fam] = mtype
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                raise ValueError(f"malformed HELP line {line!r}")
            fam = parts[2]
            if fam in helps:
                raise ValueError(f"duplicate HELP for family {fam!r}")
            raw = parts[3] if len(parts) == 4 else ""
            helps[fam] = (
                raw.replace("\\n", "\n").replace("\\\\", "\\")
            )
            continue
        if line.startswith("#"):
            continue  # comments are legal and skippable
        metric, _, value = line.rpartition(" ")
        if not metric:
            raise ValueError(f"malformed sample line {line!r}")
        name, brace, rest = metric.partition("{")
        labels: dict[str, str] = {}
        if brace:
            if not rest.endswith("}"):
                raise ValueError(f"unterminated label block in line {line!r}")
            labels = _parse_label_block(rest[:-1], line)
        try:
            parsed = float(value)
        except ValueError:
            raise ValueError(
                f"non-numeric value {value!r} in line {line!r}"
            ) from None
        samples.append((name.strip(), labels, parsed))
    return types, helps, samples
