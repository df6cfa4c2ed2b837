# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""OpenMetrics text-format rendering of the counter/gauge registry.

Maps the internal ``layer.component.event`` names onto valid OpenMetrics
families so any Prometheus-compatible scraper can consume the live plane
(:mod:`~torchmetrics_tpu_torch.obs.live`'s ``/metrics`` endpoint):

- every family is prefixed ``tm_tpu_`` and dots become underscores:
  ``sharded.cache.hit`` -> ``tm_tpu_sharded_cache_hit``;
- a name segment that is NOT a plain lowercase identifier — the metric-class
  segment of ``device.<Metric>.<field>`` or ``sketch.merge.<Class>`` — is
  hoisted into a ``metric="<segment>"`` label instead of being mangled into
  the family name: ``device.SumMetric.nan_count`` becomes
  ``tm_tpu_device_nan_count{metric="SumMetric"}``, so every metric class
  lands in ONE family and dashboards can aggregate across classes;
- counters get the mandated ``_total`` sample suffix (the ``# TYPE`` line
  carries the family name without it), gauges render verbatim;
- label values escape ``\\``, ``"`` and newlines per the spec;
- when gauge ages are known (``counters.snapshot(include_ts=True)``), each
  gauge sample carries an epoch-seconds timestamp of its last set, so a
  scraper sees WHEN the value was true instead of treating a dead gauge as
  live;
- the exposition ends with the mandatory ``# EOF``.

Standalone (stdlib only, imports neither torch nor jax) like the rest of the obs package.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_PLAIN_SEGMENT = re.compile(r"^[a-z_][a-z0-9_]*$")
_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def escape_label_value(value: str) -> str:
    """Escape a label value per the OpenMetrics ABNF (backslash first)."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def metric_family(name: str) -> Tuple[str, Dict[str, str]]:
    """Map an internal ``layer.component.event`` name to
    ``(family_name, labels)``.

    Plain lowercase segments join the family name; any other segment (a
    metric class like ``SumMetric``) becomes the ``metric`` label — extra odd
    segments join that label with ``.`` so no information is dropped.
    """
    plain: List[str] = []
    odd: List[str] = []
    for segment in name.split("."):
        if _PLAIN_SEGMENT.match(segment):
            plain.append(segment)
        else:
            odd.append(segment)
    family = "tm_tpu_" + "_".join(plain) if plain else "tm_tpu_" + _INVALID_CHARS.sub("_", name)
    labels = {"metric": ".".join(odd)} if odd else {}
    return family, labels


def _label_block(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _format_value(value) -> str:
    # integral floats render as ints: OpenMetrics accepts both, diffs are nicer
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def render(
    counters: Mapping[str, int],
    gauges: Mapping[str, float],
    labels: Optional[Mapping[str, str]] = None,
    gauge_epoch_s: Optional[Mapping[str, float]] = None,
) -> str:
    """Render one OpenMetrics exposition from a counter/gauge snapshot.

    ``labels`` are attached to every sample (the live plane passes
    ``{"rank": "<k>"}``); ``gauge_epoch_s`` maps gauge names to the epoch
    seconds of their last set — rendered as the sample timestamp so stale
    gauges are visibly stale.
    """
    shared = dict(labels or {})
    # family -> (type, [(labels, value, timestamp_s)]): one TYPE line per
    # family even when several internal names (label variants) share it
    families: Dict[str, Tuple[str, List[Tuple[Dict[str, str], float, Optional[float]]]]] = {}

    def _add(name: str, kind: str, value, ts: Optional[float]) -> None:
        family, own = metric_family(name)
        entry = families.setdefault(family, (kind, []))
        if entry[0] != kind:
            # a counter and a gauge collided into one family name — rendering
            # the gauge under the counter's TYPE (or vice versa) would be an
            # invalid exposition; give the latecomer its own suffixed family
            family = f"{family}_{kind}"
            entry = families.setdefault(family, (kind, []))
        entry[1].append(({**shared, **own}, value, ts))

    for name in sorted(counters):
        _add(name, "counter", counters[name], None)
    for name in sorted(gauges):
        ts = gauge_epoch_s.get(name) if gauge_epoch_s else None
        _add(name, "gauge", gauges[name], ts)

    lines: List[str] = []
    for family in sorted(families):
        kind, samples = families[family]
        lines.append(f"# TYPE {family} {kind}")
        sample_name = family + "_total" if kind == "counter" else family
        for sample_labels, value, ts in samples:
            stamp = f" {ts:.3f}" if ts is not None else ""
            lines.append(f"{sample_name}{_label_block(sample_labels)} {_format_value(value)}{stamp}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
