"""Prometheus-style text exporters for the serving and pool tiers.

Two renderers produce the classic ``# HELP / # TYPE / name{labels} value``
text exposition format:

* :func:`render_prometheus` — from a ``SearchServer.stats()`` snapshot
  (request counters, stage seconds, latency quantiles, queue depth,
  cache hit ratio, failover counters, pool verb totals), optionally
  joined by per-span duration histograms from the live tracer ring.
* :func:`render_pool_server` — from a ``PoolServer`` ``stats()`` payload
  (the STATS verb): per-verb request counts, service seconds, payload
  byte totals, and (for durable servers) the WAL/checkpoint/replay
  counters under ``ingest``.

Pure functions over plain dicts — no scrape endpoint is included; embed
the text wherever your deployment exposes it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

#: Histogram bucket upper bounds (seconds) for span-duration histograms.
BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
           1.0, 3.0)


def _line(name: str, value, labels: Optional[Dict[str, Any]] = None) -> str:
    """One exposition line: ``name{labels} value``."""
    lab = ""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        lab = "{" + inner + "}"
    return f"{name}{lab} {float(value):.9g}"


def _head(out: List[str], name: str, help_: str, type_: str) -> None:
    """Append the # HELP / # TYPE preamble for a metric family."""
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} {type_}")


def span_histograms(spans: Iterable[Dict[str, Any]]) -> List[str]:
    """Cumulative duration histograms per (tier, name) over raw spans."""
    counts: Dict[tuple, List[int]] = defaultdict(
        lambda: [0] * (len(BUCKETS) + 1))
    sums: Dict[tuple, float] = defaultdict(float)
    bytes_sum: Dict[tuple, float] = defaultdict(float)
    for s in spans:
        key = (s["tier"], s["name"])
        dur = float(s["dur"])
        sums[key] += dur
        bytes_sum[key] += float(s["attrs"].get("bytes", 0.0))
        row = counts[key]
        for i, ub in enumerate(BUCKETS):
            if dur <= ub:
                row[i] += 1
                break
        else:
            row[len(BUCKETS)] += 1
    out: List[str] = []
    if not counts:
        return out
    _head(out, "repro_span_seconds", "span duration by tier/name",
          "histogram")
    for key in sorted(counts):
        tier, name = key
        cum = 0
        for i, ub in enumerate(BUCKETS):
            cum += counts[key][i]
            out.append(_line("repro_span_seconds_bucket", cum,
                             {"tier": tier, "name": name, "le": repr(ub)}))
        cum += counts[key][len(BUCKETS)]
        out.append(_line("repro_span_seconds_bucket", cum,
                         {"tier": tier, "name": name, "le": "+Inf"}))
        out.append(_line("repro_span_seconds_sum", sums[key],
                         {"tier": tier, "name": name}))
        out.append(_line("repro_span_seconds_count", cum,
                         {"tier": tier, "name": name}))
    byted = {k: v for k, v in bytes_sum.items() if v}
    if byted:
        _head(out, "repro_span_bytes_total", "bytes attributed to spans",
              "counter")
        for key in sorted(byted):
            out.append(_line("repro_span_bytes_total", byted[key],
                             {"tier": key[0], "name": key[1]}))
    return out


def slo_lines(report: Dict[str, Any]) -> List[str]:
    """Exposition lines for an ``SLOTracker.report()`` dict."""
    out: List[str] = []
    if not report:
        return out
    _head(out, "repro_slo", "SLO attainment and burn rates", "gauge")
    for tier in sorted(report):
        for key in sorted(report[tier]):
            row = report[tier][key]
            lab = {"tier": tier, "key": key}
            for what in ("attainment", "burn_short", "burn_long", "burn",
                         "violations", "n"):
                out.append(_line("repro_slo", row.get(what, 0.0),
                                 dict(lab, what=what)))
            out.append(_line("repro_slo", 1.0 if row.get("met") else 0.0,
                             dict(lab, what="met")))
    return out


def tracer_lines(tracer) -> List[str]:
    """Tracer-health gauges (ring occupancy/drops, tail kept/discarded)
    from a live :class:`~repro.obs.trace.Tracer`."""
    out: List[str] = []
    if tracer is None:
        return out
    _head(out, "repro_tracer", "tracer ring + tail-sampler health",
          "gauge")
    for what, v in sorted(tracer.health().items()):
        out.append(_line("repro_tracer", float(v), {"what": what}))
    return out


def pool_hist_lines(hist: Dict[str, Any]) -> List[str]:
    """Prometheus histogram lines for a pool's nested per-(verb, shard)
    latency view (``snapshot()["hist"]``, i.e. ``VerbShardHist.to_dict``
    output).  Only buckets that advance the cumulative count are
    emitted (plus ``+Inf``) to keep the exposition compact — still a
    valid, monotone Prometheus histogram."""
    out: List[str] = []
    if not hist:
        return out
    from repro_torch.obs.hist import HIST_BOUNDS
    name = "repro_pool_verb_latency_seconds"
    _head(out, name, "observed transport latency by (verb, shard)",
          "histogram")
    for verb in sorted(hist):
        for shard in sorted(hist[verb], key=int):
            d = hist[verb][shard]
            counts = list(d.get("counts", ()))
            lab = {"verb": verb, "shard": shard}
            cum = 0
            for i, ub in enumerate(HIST_BOUNDS):
                c = counts[i] if i < len(counts) else 0
                if c:
                    cum += c
                    out.append(_line(name + "_bucket", cum,
                                     dict(lab, le=repr(ub))))
            total = sum(counts)
            out.append(_line(name + "_bucket", total,
                             dict(lab, le="+Inf")))
            out.append(_line(name + "_sum", d.get("sum_s", 0.0), lab))
            out.append(_line(name + "_count", d.get("count", total), lab))
    return out


def straggler_lines(stragglers: Dict[str, Any]) -> List[str]:
    """Gauges for a ``ShardedPool`` straggler report (detector counters
    + per-shard flags with their tail excess)."""
    out: List[str] = []
    if not stragglers:
        return out
    _head(out, "repro_straggler", "straggler-detector counters", "gauge")
    for what in ("checks", "flagged_now", "reroutes", "moved_groups"):
        if what in stragglers:
            out.append(_line("repro_straggler", stragglers[what],
                             {"what": what}))
    flagged = stragglers.get("flagged", {})
    if flagged:
        _head(out, "repro_straggler_excess_seconds",
              "flagged shard tail excess vs fleet", "gauge")
        for shard in sorted(flagged, key=int):
            info = flagged[shard]
            out.append(_line("repro_straggler_excess_seconds",
                             info.get("excess_s", 0.0),
                             {"shard": shard,
                              "verb": info.get("verb", "-")}))
    return out


def render_prometheus(stats: Dict[str, Any],
                      spans: Optional[Iterable[Dict[str, Any]]] = None,
                      tracer=None) -> str:
    """Render a ``SearchServer.stats()`` snapshot (and optionally the
    tracer's spans + the tracer's own health gauges) as Prometheus text
    exposition."""
    out: List[str] = []
    _head(out, "repro_serve_requests_total", "requests completed", "counter")
    out.append(_line("repro_serve_requests_total",
                     stats.get("n_requests", 0)))
    _head(out, "repro_serve_queries_total", "query rows served", "counter")
    out.append(_line("repro_serve_queries_total", stats.get("n_queries", 0)))
    _head(out, "repro_serve_fused_calls_total", "fused engine calls",
          "counter")
    out.append(_line("repro_serve_fused_calls_total",
                     stats.get("n_fused_calls", 0)))
    _head(out, "repro_serve_rejected_total", "admission rejections",
          "counter")
    out.append(_line("repro_serve_rejected_total",
                     stats.get("n_rejected", 0)))
    _head(out, "repro_serve_mean_fused_batch", "mean fused batch size",
          "gauge")
    out.append(_line("repro_serve_mean_fused_batch",
                     stats.get("mean_fused_batch", 0.0)))
    _head(out, "repro_serve_latency_ms", "request latency quantiles",
          "gauge")
    for p in (50, 95, 99):
        out.append(_line("repro_serve_latency_ms",
                         stats.get(f"p{p}_ms", 0.0),
                         {"quantile": f"0.{p}"}))
    _head(out, "repro_serve_stage_seconds_total",
          "cumulative per-stage seconds", "counter")
    for stage, v in sorted(stats.get("breakdown_s", {}).items()):
        out.append(_line("repro_serve_stage_seconds_total", v,
                         {"stage": stage.removesuffix("_s")}))
    _head(out, "repro_net_total", "NetLedger roll-up", "counter")
    for key, v in sorted(stats.get("net", {}).items()):
        out.append(_line("repro_net_total", v, {"what": key}))
    eng = stats.get("engine", {})
    if eng:
        _head(out, "repro_engine_total", "engine counters across fused "
              "calls", "counter")
        for key, v in sorted(eng.items()):
            out.append(_line("repro_engine_total", v, {"what": key}))
        denom = eng.get("cache_hits", 0.0) + eng.get("n_fetches", 0.0)
        _head(out, "repro_cache_hit_ratio", "span-cache hit ratio", "gauge")
        out.append(_line("repro_cache_hit_ratio",
                         eng.get("cache_hits", 0.0) / denom if denom
                         else 0.0))
    tenants = stats.get("tenants", {})
    if tenants:
        _head(out, "repro_tenant_requests_total",
              "per-tenant admission counters", "counter")
        for t, row in sorted(tenants.items()):
            for what in ("admitted", "rejected", "served"):
                out.append(_line("repro_tenant_requests_total",
                                 row.get(what, 0),
                                 {"tenant": t, "what": what}))
        _head(out, "repro_queue_depth", "live queued requests", "gauge")
        out.append(_line("repro_queue_depth",
                         sum(r.get("queued", 0) for r in tenants.values())))
    fo = stats.get("failover")
    if fo:
        _head(out, "repro_failover", "replication/failover counters",
              "gauge")
        for key, v in sorted(fo.items()):
            out.append(_line("repro_failover", v, {"what": key}))
    pool = stats.get("pool")
    if pool:
        _head(out, "repro_pool_verbs_total", "memory-pool verb counts",
              "counter")
        for verb, v in sorted(pool.get("verbs", {}).items()):
            out.append(_line("repro_pool_verbs_total", v, {"verb": verb}))
        _head(out, "repro_pool_total", "memory-pool charged totals",
              "counter")
        for key, v in sorted(pool.get("totals", {}).items()):
            out.append(_line("repro_pool_total", v, {"what": key}))
        out.extend(pool_hist_lines(pool.get("hist", {})))
    out.extend(slo_lines(stats.get("slo", {})))
    out.extend(straggler_lines(stats.get("stragglers", {})))
    out.extend(tracer_lines(tracer))
    if spans is not None:
        out.extend(span_histograms(spans))
    return "\n".join(out) + "\n"


def render_pool_server(stats: Dict[str, Any]) -> str:
    """Render a ``PoolServer`` STATS payload as Prometheus text."""
    out: List[str] = []
    _head(out, "repro_poolserver_verbs_total", "verb requests handled",
          "counter")
    for verb, v in sorted(stats.get("verbs", {}).items()):
        out.append(_line("repro_poolserver_verbs_total", v, {"verb": verb}))
    _head(out, "repro_poolserver_service_seconds_total",
          "seconds inside verb bodies", "counter")
    for verb, v in sorted(stats.get("service_s", {}).items()):
        out.append(_line("repro_poolserver_service_seconds_total", v,
                         {"verb": verb}))
    _head(out, "repro_poolserver_payload_bytes_total",
          "request/response payload bytes", "counter")
    out.append(_line("repro_poolserver_payload_bytes_total",
                     stats.get("payload_rx", 0), {"dir": "rx"}))
    out.append(_line("repro_poolserver_payload_bytes_total",
                     stats.get("payload_tx", 0), {"dir": "tx"}))
    _head(out, "repro_poolserver_uptime_seconds", "server uptime", "gauge")
    out.append(_line("repro_poolserver_uptime_seconds",
                     stats.get("uptime_s", 0.0)))
    sh = stats.get("service_hist")
    if sh:
        from repro_torch.obs.hist import HIST_BOUNDS
        name = "repro_poolserver_service_seconds"
        _head(out, name, "per-verb service-time histogram", "histogram")
        for verb in sorted(sh):
            d = sh[verb]
            counts = list(d.get("counts", ()))
            cum = 0
            for i, ub in enumerate(HIST_BOUNDS):
                c = counts[i] if i < len(counts) else 0
                if c:
                    cum += c
                    out.append(_line(name + "_bucket", cum,
                                     {"verb": verb, "le": repr(ub)}))
            total = sum(counts)
            out.append(_line(name + "_bucket", total,
                             {"verb": verb, "le": "+Inf"}))
            out.append(_line(name + "_sum", d.get("sum_s", 0.0),
                             {"verb": verb}))
            out.append(_line(name + "_count", d.get("count", total),
                             {"verb": verb}))
    ing = stats.get("ingest")
    if ing:
        _head(out, "repro_poolserver_ingest_total",
              "durability counters (WAL/checkpoint/replay)", "counter")
        for key, v in sorted(ing.items()):
            out.append(_line("repro_poolserver_ingest_total", float(v),
                             {"what": key}))
    return "\n".join(out) + "\n"
