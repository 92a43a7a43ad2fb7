"""The profiled part of a traced window.

``torch.profiler`` with CUDA activity records every device operation and
the runtime call that launched it.  A window that launches tens of
thousands of kernels a second would give millions of events, so the
profiler covers only the first ``seconds`` of the window (the traffic
mix's ``profile_seconds``), starting and stopping between batches.
"""
from __future__ import annotations

import time

import torch

from bench.yardstick import trace as TR


class WindowProfiler:
    """Starts at the first ``tick`` and stops at the first ``tick`` at or
    past ``seconds`` into the window (or at ``close``).  Off on the CPU,
    where there is no device to trace."""

    def __init__(self, enabled: bool, seconds: float, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.seconds = seconds
        self.device = torch.device(device)
        self.prof = None
        self.active = False
        self.window_ns = None
        self.offset_ns = 0

    def warm(self) -> None:
        """Profile one small operation, so the tracer's own start-up (CUPTI)
        is paid in set-up and not in the window."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def tick(self, elapsed_s: float) -> None:
        """Between batches: start, or stop once past ``seconds``."""
        if not self.enabled:
            return
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(self.device)
            self.offset_ns = TR.clock_offset_ns()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.active = True
            self._w0 = time.time_ns()
        elif self.active and elapsed_s >= self.seconds:
            self.close()

    def close(self) -> None:
        if self.active:
            torch.cuda.synchronize(self.device)
            w1 = time.time_ns()
            self.prof.__exit__(None, None, None)
            self.active = False
            self.window_ns = (self._w0, w1)

    def device_trace(self, spans: list):
        """The profiled part as a ``DeviceTrace``; None if nothing ran on
        the device or the profiler did not run."""
        if self.prof is None or self.window_ns is None:
            return None
        t = TR.DeviceTrace.from_profiler(self.prof, spans, self.window_ns,
                                         self.offset_ns)
        return t if t.n_ops else None
