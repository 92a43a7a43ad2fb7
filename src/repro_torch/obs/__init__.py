"""Observability for the port: the reference's span recorder, latency
histograms, SLO tracker, metrics exporter and breakdown report, copied
(they import no framework).  ``python -m repro_torch.obs.report
trace.json`` prints a saved trace's per-stage breakdown."""
from repro_torch.obs.hist import (HIST_BOUNDS, LatencyHistogram,
                                  StragglerDetector, VerbShardHist)
from repro_torch.obs.slo import SLO, SLOTracker, parse_slo
from repro_torch.obs.trace import TRACER, Tracer, chrome_trace, load_trace

__all__ = ["TRACER", "Tracer", "chrome_trace", "load_trace",
           "HIST_BOUNDS", "LatencyHistogram", "VerbShardHist",
           "StragglerDetector", "SLO", "SLOTracker", "parse_slo"]
