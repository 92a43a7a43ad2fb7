"""The wire's price, frozen: the paper's testbed fabric.

A copy of the arithmetic of ``repro_torch/core/cost_model.py``'s
``RDMA_100G`` (ConnectX-6, 100 Gb): 2 us a round trip, 0.25 us a doorbell
descriptor, 12.5 GB/s of payload.  The program counts round trips,
descriptors and bytes in ``stats["net"]``; the benchmark prices them here.
"""
from __future__ import annotations

RTT_S = 2e-6
PER_DESCRIPTOR_S = 0.25e-6
BW_BYTES_S = 12.5e9


def wire_seconds(round_trips: float, descriptors: float,
                 n_bytes: float) -> float:
    """Modelled time on the wire of the counted traffic."""
    return (round_trips * RTT_S + descriptors * PER_DESCRIPTOR_S
            + n_bytes / BW_BYTES_S)


def us_per_query(nets: list[dict], n_queries: int) -> float:
    """The summed wire time of ``nets`` (``stats["net"]`` dicts) over
    ``n_queries``, in microseconds."""
    s = sum(wire_seconds(n["round_trips"], n["descriptors"], n["bytes"])
            for n in nets)
    return s / n_queries * 1e6
