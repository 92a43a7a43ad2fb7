"""Observability for the port: the reference's span recorder, latency
histograms, SLO tracker and metrics exporter, copied (they import no
framework)."""
from repro_torch.obs.hist import (HIST_BOUNDS, LatencyHistogram,
                                  StragglerDetector, VerbShardHist)
from repro_torch.obs.slo import SLO, SLOTracker, parse_slo
from repro_torch.obs.trace import TRACER, Tracer

__all__ = ["TRACER", "Tracer", "HIST_BOUNDS", "LatencyHistogram",
           "VerbShardHist", "StragglerDetector", "SLO", "SLOTracker",
           "parse_slo"]
