"""Prometheus text exposition of the Expvar store.

Renders an :meth:`ExpvarStatsClient.snapshot` dict (counts / gauges /
histograms keyed by tag-qualified names like ``setBit[frame:f,index:i]``)
in the Prometheus text format (version 0.0.4), served by ``GET /metrics``:

* counts      → ``pilosa_<name>_total`` counters
* gauges      → ``pilosa_<name>`` gauges
* histograms  → ``pilosa_<name>`` summaries (quantile series + ``_sum``
  and ``_count``); quantiles are the snapshot's interpolated
  percentiles over the bounded reservoir (a WINDOWED view), while
  ``_sum``/``_count`` come from the lifetime monotonic totals so
  ``rate()`` keeps working past 4096 observations
* hierarchical tags (``index:i``, ``frame:f``, ``view:standard``,
  ``slice:0``) → labels; a bare tag becomes ``tag="..."``.

Sets (string-valued) have no numeric representation and are skipped.
"""

from __future__ import annotations

import re

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")

_QUANTILES = (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99"), ("0.999", "p999"))


def _metric_name(raw: str, prefix: str = "pilosa") -> str:
    name = _NAME_OK.sub("_", raw).strip("_")
    if not name:
        name = "unnamed"
    if name[0].isdigit():
        name = "_" + name
    return f"{prefix}_{name}"


def _label_name(raw: str) -> str:
    name = _LABEL_OK.sub("_", raw)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def parse_key(key: str) -> tuple[str, dict[str, str]]:
    """``name[tag1,tag2]`` -> (name, labels).  Tags are ``k:v`` pairs
    (``index:i``); a tag without a colon maps to label ``tag``."""
    name, _, rest = key.partition("[")
    labels: dict[str, str] = {}
    if rest.endswith("]"):
        for tag in rest[:-1].split(","):
            if not tag:
                continue
            k, sep, v = tag.partition(":")
            if sep:
                labels[_label_name(k)] = v
            else:
                labels[_label_name("tag")] = tag
    return name, labels


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(snapshot: dict, extra_gauges: dict | None = None) -> str:
    """Snapshot -> exposition text.  ``extra_gauges`` are pre-named
    process metrics (uptime, threads) rendered without the key parsing."""
    # family name -> {"type": ..., "lines": [...]}; one # TYPE header per
    # family no matter how many label sets share the name.
    families: dict[str, dict] = {}

    def family(name: str, typ: str) -> list[str]:
        f = families.setdefault(name, {"type": typ, "lines": []})
        return f["lines"]

    for raw_key, value in sorted((snapshot.get("counts") or {}).items()):
        name, labels = parse_key(raw_key)
        fam = _metric_name(name) + "_total"
        family(fam, "counter").append(
            f"{fam}{_fmt_labels(labels)} {_fmt_value(value)}"
        )

    for raw_key, value in sorted((snapshot.get("gauges") or {}).items()):
        name, labels = parse_key(raw_key)
        fam = _metric_name(name)
        family(fam, "gauge").append(
            f"{fam}{_fmt_labels(labels)} {_fmt_value(value)}"
        )

    for raw_key, h in sorted((snapshot.get("histograms") or {}).items()):
        name, labels = parse_key(raw_key)
        fam = _metric_name(name)
        lines = family(fam, "summary")
        for q, pkey in _QUANTILES:
            if pkey in h:
                qlabels = dict(labels, quantile=q)
                lines.append(f"{fam}{_fmt_labels(qlabels)} {_fmt_value(h[pkey])}")
        # _sum/_count must be lifetime monotonic for rate() to work;
        # the snapshot carries them separately from the windowed
        # reservoir ("count"/"sum" vs "n"/"mean").  Fall back to the
        # reservoir view only for pre-upgrade snapshots.
        if "count" in h:
            lines.append(
                f"{fam}_sum{_fmt_labels(labels)} {_fmt_value(h.get('sum', 0.0))}"
            )
            lines.append(
                f"{fam}_count{_fmt_labels(labels)} {_fmt_value(h['count'])}"
            )
        elif "n" in h:
            mean = h.get("mean", 0.0)
            lines.append(
                f"{fam}_sum{_fmt_labels(labels)} {_fmt_value(mean * h['n'])}"
            )
            lines.append(f"{fam}_count{_fmt_labels(labels)} {_fmt_value(h['n'])}")

    for name, value in sorted((extra_gauges or {}).items()):
        fam = _metric_name(name)
        family(fam, "gauge").append(f"{fam} {_fmt_value(value)}")

    out: list[str] = []
    for fam in sorted(families):
        ent = families[fam]
        out.append(f"# TYPE {fam} {ent['type']}")
        out.extend(ent["lines"])
    return "\n".join(out) + ("\n" if out else "")
