"""Network cost model — round trips + bytes, for RDMA and TPU ICI fabrics.

The container has no real fabric, so (exactly like the paper's latency
*breakdown* methodology) we count the communication events each scheme
issues and price them with calibrated constants.  Two calibrations:

* ``RDMA_100G``  — the paper's testbed (ConnectX-6 100 Gb NIC): one-sided
  READ round-trip ~2 us, ~12.5 GB/s payload bandwidth, and a per-doorbell
  -descriptor PCIe cost (~0.25 us) that models the NIC issuing multiple
  PCIe transactions inside one network round trip (§3.2's tradeoff).
* ``TPU_ICI``    — our target fabric: ~1 us collective launch latency,
  ~50 GB/s/link.  A doorbell batch maps to ONE collective launch whose
  payload is the union of requested blocks.

Both share the accounting: latency = round_trips * rtt
                                   + descriptors * per_op
                                   + bytes / bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Fabric:
    name: str
    rtt_s: float            # per network round trip
    bw_Bps: float           # payload bandwidth
    per_op_s: float = 0.0   # per doorbell descriptor (PCIe op / DMA engine op)
    max_doorbell: int = 32  # descriptors per round trip before it splits


RDMA_100G = Fabric("rdma-100g", rtt_s=2e-6, bw_Bps=12.5e9, per_op_s=0.25e-6,
                   max_doorbell=32)
TPU_ICI = Fabric("tpu-ici", rtt_s=1e-6, bw_Bps=50e9, per_op_s=0.05e-6,
                 max_doorbell=64)


@dataclass
class NetLedger:
    """Mutable tally a scheme run writes into; priced at the end."""

    fabric: Fabric
    round_trips: float = 0.0
    descriptors: float = 0.0
    bytes: float = 0.0
    bytes_saved: float = 0.0   # wire bytes avoided vs full-precision spans
    events: int = 0

    def read(self, n_bytes: float, *, descriptors: int = 1) -> None:
        """One round trip carrying ``descriptors`` doorbell'd reads."""
        import math
        trips = math.ceil(descriptors / self.fabric.max_doorbell)
        self.round_trips += trips
        self.descriptors += descriptors
        self.bytes += n_bytes
        self.events += 1

    def write(self, n_bytes: float, *, descriptors: int = 1) -> None:
        self.read(n_bytes, descriptors=descriptors)

    def save(self, n_bytes: float) -> None:
        """Record bytes the quantized tier / row re-rank kept OFF the
        wire relative to fetching the same spans in full precision."""
        self.bytes_saved += max(n_bytes, 0.0)

    def latency_s(self) -> float:
        f = self.fabric
        return (self.round_trips * f.rtt_s + self.descriptors * f.per_op_s
                + self.bytes / f.bw_Bps)

    def as_dict(self) -> dict:
        return {"fabric": self.fabric.name,
                "round_trips": self.round_trips,
                "descriptors": self.descriptors,
                "bytes": self.bytes,
                "bytes_saved": self.bytes_saved,
                "latency_s": self.latency_s()}
