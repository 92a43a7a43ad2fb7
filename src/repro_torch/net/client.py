"""RemotePool — the MemoryPool verbs issued as RDMA-style work requests.

Port of ``repro/net/client.py``.  The memory node holds the region in host
memory (a ``PoolServer`` process, or an in-process ``HostRegion`` behind
the loopback bearer); the compute side runs on ``device``.  Every response
is decoded on the host with numpy, the doorbell rounds of one call are
concatenated there, and each returned tensor is uploaded to ``device``
once a call (``torch.from_numpy(...).to(device)``), with the dtypes and
shapes the port's ``LocalPool`` returns (int32 graph blocks, f32 vectors,
int8 codes, f32 scales), so the serve path cannot tell the pools apart.
Row arguments that arrive on the card are copied to the host once, at
the start of the verb.

A full ``MemoryPool`` implementation whose region lives behind a
:class:`repro_torch.rdma.verbs.QueuePair`: span/row reads are WR-list READs
against the remote's registered memory regions (one ``post_send`` ==
one doorbell batch == one frame), appends are a ``WRITE_WITH_IMM`` into
the shared overflow MR, and repack/migration land as block-granular
WRITE batches closed by an IMM control message.  Two bearers carry the
frames:

* ``bearer="tcp"`` (default) — the TCP-emulated bearer
  (``repro_torch.rdma.tcp``) to a standalone ``PoolServer`` process; bytes
  really cross a socket.
* ``bearer="loopback"`` — an in-process ``HostRegion`` behind the
  loopback bearer (``repro_torch.rdma.loopback``): same frames, same MR
  delegation, synchronous completions, no sockets — the pool still
  uploads its region via ATTACH, so the loopback region is an
  independent deep copy and the bit-identity gate is as real as over
  TCP.

Completions are polled one at a time while later batches are still in
flight, so round r's payload is decoded while round r+1's response is
on the wire (double-buffered doorbell submission).  The pool keeps a
``wire`` tally of *measured* frames and payload bytes per verb next to
the modeled charge, and ``snapshot()["wire_vs_model"]`` cross-checks the
two — the protocol is constructed so that data-verb payloads equal the
``Fabric`` model's priced bytes exactly (see ``wire.py``).

Client-side mirror: the pool keeps the host ``Store`` it was built from
(the compute node built the index; ATTACH uploaded it).  The mirror is
**control-plane only** — the cached global metadata block the paper lets
compute instances hold, plus the write staging repack needs.  Every
index byte the search path consumes arrives through a wire verb; writes
are applied to both sides deterministically (``layout.insert_vector``
here, the same routine in the server) and the append response slot is
cross-checked so the two regions can never silently diverge.

Accounting parity: ``NetLedger`` charges use the measured response
payload for span reads (== the modeled bytes by protocol construction)
and the same model formulas as ``LocalPool`` for the ``post_*``
accounting verbs — so a RemotePool engine's ``stats["net"]`` is
bit-identical to LocalPool's, while ``snapshot()["wire"]`` additionally
reports what really moved.

Failure mode: any transport error (refused, reset, timeout, EOF) closes
the connection and raises ``PoolUnavailableError`` — a killed server is
a clean exception at the next verb, never a hang.
"""
from __future__ import annotations

import socket
import threading
import time
import zlib
from collections import Counter
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import layout as LA
from repro_torch.core.cost_model import RDMA_100G, Fabric, NetLedger
from repro_torch.core.layout import Store
from repro_torch.core.scheduler import doorbell_chunks
from repro_torch.net import wire as W
from repro_torch.obs.trace import TRACER
from repro_torch.pool.protocol import (MemoryPool, PoolUnavailableError,
                                 _fresh_totals, span_wire_bytes)
from repro_torch.rdma import verbs as V
from repro_torch.rdma.loopback import LoopbackBearer
from repro_torch.rdma.tcp import TcpBearer

__all__ = ["RemotePool", "PoolUnavailableError", "parse_endpoint"]

Endpoint = Union[str, tuple]


def parse_endpoint(ep: Endpoint) -> tuple:
    """'host:port' or (host, port) -> (host, port)."""
    if isinstance(ep, str):
        host, _, port = ep.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad endpoint {ep!r} (want host:port)")
        return host, int(port)
    host, port = ep
    return str(host), int(port)


class RemotePool(MemoryPool):
    """MemoryPool over TCP: verbs marshaled to a ``PoolServer``.

    Keeps a host mirror of the region (writes run the same
    deterministic insert on both sides), counts every byte that crosses
    the socket per verb (``wire``), and cross-checks measured payloads
    against the ledger model (``wire_vs_model``).  A dead or
    unreachable server raises ``PoolUnavailableError`` instead of
    hanging — the hook a replicated ``ShardedPool`` parent fails over
    on.
    """

    kind = "remote"

    def __init__(self, store: Store, endpoint: Optional[Endpoint] = None, *,
                 device, fabric: Optional[Fabric] = None,
                 timeout_s: float = 60.0,
                 connect_timeout_s: float = 10.0, attach: str = "always",
                 bearer: str = "tcp"):
        assert attach in ("always", "auto"), attach
        assert bearer in ("tcp", "loopback"), bearer
        if bearer == "tcp" and endpoint is None:
            raise ValueError("bearer='tcp' requires an endpoint")
        self.store = store
        self.device = torch.device(device)
        self.bearer_kind = bearer
        self.endpoint = (parse_endpoint(endpoint) if endpoint is not None
                         else ("loopback", 0))
        self.fabric = fabric or RDMA_100G
        self.timeout_s = timeout_s
        self.verbs: Counter = Counter()
        self.totals = _fresh_totals()
        # measured wire traffic (frame headers counted separately from
        # payloads so the model cross-check sees pure data bytes); the
        # dict is shared by reference with the bearer, which owns the
        # frame/byte counters
        self.wire = {"frames_tx": 0, "frames_rx": 0,
                     "bytes_tx": 0, "bytes_rx": 0,
                     "payload_by_verb": {}, "model_by_verb": {},
                     "frames_by_verb": {}, "wire_s": {},
                     "inflight_peak": 0}
        self._lock = threading.Lock()
        self._server_trace = False
        self.attached_via = "upload"
        if bearer == "tcp":
            try:
                self._bearer = TcpBearer(
                    self.endpoint, timeout_s=timeout_s,
                    connect_timeout_s=connect_timeout_s, counters=self.wire)
            except OSError as e:
                raise PoolUnavailableError(
                    f"pool server {self.endpoint} unreachable: {e}") from e
        else:
            # in-process MR host: the region is still populated through
            # the same ATTACH path (a deep copy of the mirror), so the
            # loopback pool exercises the full wire codec + MR
            # delegation stack the TCP bearer does
            from repro_torch.net.server import HostRegion
            self._region = HostRegion()
            self._bearer = LoopbackBearer(self._region, counters=self.wire)
        self._qp = V.QueuePair(self._bearer)
        self.mrs = V.region_mrs(store.spec,
                                quant=store.qvec_buf is not None)
        self._probe_caps()
        # recovery handshake: a durable server that already holds a
        # region matching our mirror (it recovered from its data-dir)
        # does not need the multi-MB ATTACH re-upload
        if attach == "auto" and self._server_region_matches():
            self.attached_via = "recovered"
        else:
            self._attach()
        self._mt_dev = self._up(self.store.meta_table)
        self._mt_dirty = False

    # ------------------------------------------------------------ transport

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """One host -> device upload of a decoded response (or the meta
        table): the compute side's copy of what crossed the wire."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _fail(self, e: Exception):
        self.close()
        raise PoolUnavailableError(
            f"pool server {self.endpoint} unavailable: {e}") from e

    def close(self) -> None:
        """Drop the connection (idempotent); the server keeps running."""
        b = getattr(self, "_bearer", None)
        if b is not None and not b.closed:
            b.close()

    def __del__(self):  # pragma: no cover - GC cleanup only
        try:
            self.close()
        except Exception:
            pass

    def _probe_caps(self) -> None:
        """One PING at connect: a server that understands the
        trace-context prefix acks with FLAG_TRACE on the response; the
        prefix is only ever sent to servers that acked (old servers are
        never shown bytes they would mis-decode)."""
        if self._bearer.closed:
            return
        with self._lock:
            try:
                self._bearer.submit(W.OP_PING, b"")
                rop, rflags, _ = self._bearer.complete()
                if rop != W.OP_PING:
                    raise ConnectionError("bad ping response")
            except (ConnectionError, socket.timeout, OSError) as e:
                self._fail(e)
        self._server_trace = bool(rflags & W.FLAG_TRACE)

    def _exchange(self, wr_lists, *, verb: str, decode=None):
        """Pipelined doorbell rounds through the queue pair.

        Every WR list is posted up front (one ``post_send`` == one
        doorbell batch == one frame == one counted trip), then
        completions are polled one at a time — so ``decode(i, payload)``
        for round ``i`` runs while round ``i+1``'s response is still in
        flight (double-buffered submission; ``wire["inflight_peak"]``
        records the deepest pipeline seen).

        With tracing enabled the whole exchange is one ``net.<verb>``
        span, and (when the server acked FLAG_TRACE at connect) each
        frame carries that span's trace context OUTSIDE the verb
        payload: ledger charges use response payloads and the modeled
        write bytes, so accounting is bit-identical with tracing on or
        off.

        A remote verb error surfaces as an error completion; the
        remaining completions are still drained (leaving them queued
        would desynchronize every later verb) and the first error is
        raised as ``RuntimeError`` after the drain.  Transport errors
        close the bearer and raise ``PoolUnavailableError``."""
        if self._bearer.closed:
            raise PoolUnavailableError(
                f"pool server {self.endpoint} connection closed")
        t0 = time.perf_counter()
        with TRACER.span("net." + verb, tier="net", frames=len(wr_lists),
                         endpoint=f"{self.endpoint[0]}:{self.endpoint[1]}") \
                as vspan:
            prefix = b""
            if TRACER.enabled and self._server_trace:
                prefix = W.enc_trace_ctx(TRACER.trace_id,
                                         getattr(vspan, "span_id", 0))
            with self._lock:
                try:
                    with TRACER.span("net.encode", tier="net"):
                        for wrs in wr_lists:
                            self._qp.post_send(wrs, prefix=prefix)
                    self.wire["inflight_peak"] = max(
                        self.wire["inflight_peak"], len(wr_lists))
                    outs, error = [], None
                    with TRACER.span("net.wire", tier="net"):
                        for i in range(len(wr_lists)):
                            comp = self._qp.cq.poll(1)[0]
                            if comp.status != V.WC_SUCCESS:
                                if error is None:
                                    error = comp.error
                                outs.append(comp.data)
                            elif decode is not None and error is None:
                                outs.append(decode(i, comp.data))
                            else:
                                outs.append(comp.data)
                        if error is not None:
                            raise RuntimeError(f"pool server error: {error}")
                except (ConnectionError, socket.timeout, OSError) as e:
                    self._fail(e)
        dt = time.perf_counter() - t0
        self.wire["wire_s"][verb] = (self.wire["wire_s"].get(verb, 0.0)
                                     + dt)
        self.wire["frames_by_verb"][verb] = (
            self.wire["frames_by_verb"].get(verb, 0) + len(wr_lists))
        # measured post->poll seconds into the per-(verb, shard) latency
        # histogram — the real-wire twin of the simulated transports'
        # modeled dt (protocol._charge records those)
        self._observe(verb, dt)
        return outs

    def _rpc(self, op, payload=b"", *, flags=0, verb="misc"):
        """Control-plane round trip: one two-sided SEND work request."""
        return self._exchange([[V.send_wr(op, payload, flags=flags)]],
                              verb=verb)[0]

    def _note(self, verb: str, measured: int, modeled: float) -> None:
        w = self.wire
        w["payload_by_verb"][verb] = (w["payload_by_verb"].get(verb, 0)
                                      + measured)
        w["model_by_verb"][verb] = (w["model_by_verb"].get(verb, 0.0)
                                    + modeled)

    def model_dt(self, n_bytes: float, descriptors: float,
                 trips: float) -> float:
        """Modeled seconds of one charge slice — lets ShardedPool's
        placement policies rank remote shards like simulated ones."""
        f = self.fabric
        return (trips * f.rtt_s + descriptors * f.per_op_s
                + n_bytes / f.bw_Bps)

    # ------------------------------------------------------------ staging

    def _local_fingerprint(self) -> dict:
        """Mirror-side twin of ``HostRegion.fingerprint`` (same CRC)."""
        st = self.store
        crc = zlib.crc32(st.meta_table.tobytes())
        crc = zlib.crc32(st.n_base.tobytes(), crc)
        return {"n_blocks": int(st.spec.n_blocks),
                "n_partitions": int(st.spec.n_partitions),
                "n_base": int(st.n_base.sum()), "crc": int(crc)}

    def _server_region_matches(self) -> bool:
        """Recovery handshake: does the server already hold our region?

        True only when the server advertises a fingerprint equal to the
        local mirror's AND (if the mirror carries a quantized tier) the
        recovered region carries one too.
        """
        st = self.server_stats()
        if not st.get("attached"):
            return False
        if st.get("region_fingerprint") != self._local_fingerprint():
            return False
        if self.store.qvec_buf is not None and not st.get("quant_attached"):
            return False
        return True

    def _attach(self) -> None:
        payload, flags = W.enc_attach(self.store)
        self._rpc(W.OP_ATTACH, payload, flags=flags, verb="attach")
        self._note("attach", len(payload), 0.0)

    def adopt(self, store: Store) -> None:
        """See ``MemoryPool.adopt``; re-uploads the full region and
        re-registers the client-side MR table against the new spec."""
        self.store = store
        self.mrs = V.region_mrs(store.spec,
                                quant=store.qvec_buf is not None)
        self._attach()
        self._mt_dev = self._up(self.store.meta_table)
        self._mt_dirty = False

    def attach_quant(self, group: int) -> None:
        """See ``MemoryPool.attach_quant``; uploads the mirror and
        registers the quant-row MR."""
        LA.attach_quant_mirror(self.store, group)
        self.mrs = V.region_mrs(self.spec, quant=True)
        self._stage_quant()

    def _stage_quant(self) -> None:
        """Ship the (already attached) host mirror to the server — the
        hook a sharded parent calls on every child after attaching the
        mirror once on the shared host store."""
        payload = W.enc_attach_quant(self.store)
        self._rpc(W.OP_ATTACH_QUANT, payload, verb="attach")
        self._note("attach", len(payload), 0.0)

    def _write_blocks(self, block_ids, verb: str) -> int:
        """Block-granular region write as one doorbell batch: a WRITE
        descriptor per block (addr = block id, len = block bytes) closed
        by a WRITE_WITH_IMM carrying the serialized payload + metadata
        table, IMM = block count.  Returns the payload bytes shipped."""
        payload, flags = W.enc_write_blocks(self.store, block_ids)
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        bb = self.spec.block_bytes()
        wrs = [V.write_wr(V.RKEY_REGION, b, length=bb) for b in ids]
        wrs.append(V.write_imm_wr(V.RKEY_REGION, 0, payload, len(ids),
                                  flags=flags))
        self._exchange([wrs], verb=verb)
        return len(payload)

    def refresh_blocks(self, block_ids) -> None:
        """Migration landing on this node: ship the group's blocks (and
        the metadata table, so the destination's overflow counters match
        the sender's) from the host region."""
        shipped = self._write_blocks(block_ids, "migrate")
        self._note("migrate", shipped, 0.0)

    # ------------------------------------------------------------ reads

    # read_meta is the shared MemoryPool implementation: the paper's
    # cached global metadata block is the client mirror — never a wire
    # round trip

    def server_meta(self):
        """The server's own metadata table — a coherence probe for tests
        and tools, not part of the serve path."""
        payload = self._rpc(W.OP_READ_META, verb="read_meta")
        return W.dec_meta_resp(payload, self.spec.n_partitions)

    def read_spans(self, pids, *, ledger: Optional[NetLedger],
                   doorbell: int = 1, quant: bool = False,
                   quant_graph: bool = True):
        """See ``MemoryPool.read_spans``; one doorbell batch is one
        request frame, and the measured response payload must equal the
        modeled ``span_wire_bytes`` charge (``wire_vs_model``)."""
        spec = self.spec
        pids = np.asarray(pids).reshape(-1)
        verb = "read_spans_quant" if quant else "read_spans"
        self.verbs[verb] += len(pids)
        per_bytes, per_desc = span_wire_bytes(spec, quant=quant,
                                              quant_graph=quant_graph)
        flags = ((W.FLAG_QUANT if quant else 0)
                 | (W.FLAG_GRAPH if quant and quant_graph else 0))
        chunks = doorbell_chunks(pids, doorbell) if len(pids) else []
        wr_lists = [[V.read_wr(V.RKEY_SPANS, p, per_bytes, flags=flags)
                     for p in db] for db in chunks]

        def dec(i, payload):
            db = chunks[i]
            measured = len(payload)
            self._note(verb, measured, len(db) * per_bytes)
            # the ledger is charged from the MEASURED response payload —
            # equal to the modeled bytes by protocol construction, which
            # wire_vs_model() verifies instead of assumes
            self._charge(verb, ledger, measured, per_desc * len(db))
            with TRACER.span("net.decode", tier="net", bytes=measured):
                return W.dec_spans_resp(spec, payload, m=len(db),
                                        quant=quant, graph=quant_graph)

        parts = (self._exchange(wr_lists, verb=verb, decode=dec)
                 if chunks else [])
        m = len(pids)
        if not quant:
            g = np.concatenate([p[0] for p in parts]) if parts else \
                np.zeros((0, spec.fetch_blocks, spec.gblk), np.int32)
            v = np.concatenate([p[1] for p in parts]) if parts else \
                np.zeros((0, spec.fetch_blocks, spec.vblk), np.float32)
            return self._up(g), self._up(v)
        qv = np.concatenate([p[0] for p in parts]) if parts else \
            np.zeros((0, spec.fetch_blocks, spec.vblk), np.int8)
        qs = np.concatenate([p[1] for p in parts]) if parts else \
            np.zeros((0, spec.fetch_blocks, spec.n_qgroups), np.float32)
        if quant_graph:
            g = np.concatenate([p[2] for p in parts]) if parts else \
                np.zeros((0, spec.fetch_blocks, spec.gblk), np.int32)
        else:
            tails = (np.concatenate([p[2] for p in parts]) if parts else
                     np.zeros((0, spec.np_max + spec.ov_cap), np.int32))
            g = W.rebuild_quant_gspans(
                spec, tails, W.span_sides(self.store.meta_table, pids))
        assert qv.shape[0] == m
        return self._up(g), self._up(qv), self._up(qs)

    def _fetch_rows(self, rows, rkey, unit_bytes, verb):
        """Deduplicated row fetch: one WR-list READ against the row MR
        moves each distinct region row once; the full (possibly
        duplicated / dead-lane) tensor is rebuilt client-side — same
        values ``LocalPool``'s device gather produces, minus the
        redundant wire bytes."""
        # a row tensor on the card comes to the host once: the verb's one
        # host sync
        rows_h = (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
                  else np.asarray(rows))
        safe = np.maximum(rows_h.astype(np.int64), 0)
        uniq, inv = np.unique(safe, return_inverse=True)
        if uniq.size == 0:                 # nothing to fetch, no frame
            return rows_h, uniq, inv, b""
        wrs = [V.read_wr(rkey, r, unit_bytes) for r in uniq]
        payload = self._exchange([wrs], verb=verb)[0]
        return rows_h, uniq, inv, payload

    def read_rows(self, rows):
        """See ``MemoryPool.read_rows``; unique rows cross the wire once
        (``n_uniq * row_bytes()``), duplicates rebuilt client-side."""
        self.verbs["read_rows"] += 1
        spec = self.spec
        rows_h, uniq, inv, payload = self._fetch_rows(
            rows, V.RKEY_ROWS, spec.row_bytes(), "read_rows")
        self._note("read_rows", len(payload),
                   len(uniq) * spec.row_bytes())
        with TRACER.span("net.decode", tier="net", bytes=len(payload)):
            vrows = W.dec_rows_resp(payload, len(uniq), spec.dim)
        out = vrows[inv].reshape(rows_h.shape + (spec.dim,))
        return self._up(out)

    def read_quant_rows(self, rows):
        """See ``MemoryPool.read_quant_rows``; ships int8 codes + f32
        group scales per unique row."""
        self.verbs["read_quant_rows"] += 1
        spec = self.spec
        nq = spec.dim // spec.quant_group
        rows_h, uniq, inv, payload = self._fetch_rows(
            rows, V.RKEY_QROWS, spec.dim + nq * 4, "read_quant_rows")
        self._note("read_quant_rows", len(payload),
                   len(uniq) * (spec.dim + nq * 4))
        with TRACER.span("net.decode", tier="net", bytes=len(payload)):
            codes, scales = W.dec_quant_rows_resp(payload, len(uniq),
                                                  spec.dim,
                                                  spec.quant_group)
        codes = codes[inv].reshape(rows_h.shape + (spec.dim,))
        scales = scales[inv].reshape(rows_h.shape + (nq,))
        return self._up(codes), self._up(scales)

    # the post_* accounting verbs are the shared MemoryPool
    # implementations: they charge without moving data, so nothing
    # crosses the wire and the math is LocalPool's by construction

    # ------------------------------------------------------------ writes

    def append(self, vec, gid: int, pid: int, *,
               ledger: Optional[NetLedger]) -> int:
        """See ``MemoryPool.append``; charges the modeled write bytes
        while the wire carries the same payload + the 8-byte partition
        address, and asserts the server landed the identical slot."""
        spec = self.spec
        vec = np.asarray(vec, np.float32)
        # stage on the mirror first: a full overflow region is decided
        # locally (both sides run the same deterministic insert, so a
        # local -1 means the server would refuse too — no wasted trip)
        slot = LA.insert_vector(self.store, vec, int(gid), int(pid))
        if slot < 0:
            return slot
        codes = scales = None
        wire_model = spec.dim * 4 + 8
        if self.store.qvec_buf is not None:
            from repro_torch.quant.codec import quantize_groups
            codes, scales = quantize_groups(vec, spec.quant_group)
            wire_model += spec.dim + (spec.dim // spec.quant_group) * 4
            group = int(self.store.meta_table[pid, LA.MT_GROUP])
            co = LA.overflow_write_coords(spec, group, slot)
            LA.refresh_quant_blocks(self.store, [co["vec_block"]])
        payload, flags = W.enc_append(vec, int(gid), int(pid), codes, scales)
        # one-sided WRITE_WITH_IMM into the shared overflow MR: the
        # descriptor names the partition address, the immediate carries
        # the gid the passive side is notified with
        wrs = [V.write_imm_wr(V.RKEY_OVERFLOW, pid, payload, gid,
                              flags=flags)]
        resp = self._exchange([wrs], verb="append")[0]
        rslot = W.dec_append_resp(resp)
        if rslot != slot:
            raise RuntimeError(
                f"remote region diverged: append slot {rslot} != "
                f"mirror slot {slot} (pid {pid})")
        self.verbs["append"] += 1
        self._note("append", len(payload), wire_model)
        self._charge_write("append", ledger, wire_model)
        self._mt_dirty = True
        self._notify_mutation("append",
                              group=int(self.store.meta_table[
                                  pid, LA.MT_GROUP]),
                              pid=int(pid), slot=int(slot))
        return slot

    def repack(self, group: int, data_lookup) -> bool:
        """Offline re-pack: rebuild on the compute side (it owns the
        vectors), then WRITE the rewritten group region to the server in
        one block-granular frame."""
        self.verbs["repack"] += 1
        ok = LA.repack_group(self.store, group, data_lookup)
        if not ok:
            return False
        LA.refresh_quant_group(self.store, group)
        spec = self.spec
        blocks = np.arange(group * spec.group_blocks,
                           (group + 1) * spec.group_blocks)
        shipped = self._write_blocks(blocks, "repack")
        self._note("repack", shipped, 0.0)
        self._mt_dirty = True
        self._notify_mutation("repack", group=int(group))
        return True

    # ------------------------------------------------------------ stats

    def wire_vs_model(self) -> dict:
        """Measured payload bytes vs the Fabric model's priced bytes,
        per data verb.  Span verbs must match exactly (the conformance
        suite asserts it); row verbs may exceed the model by exactly the
        rows the compute-side residency policy counts as free."""
        out = {}
        for verb, measured in self.wire["payload_by_verb"].items():
            modeled = self.wire["model_by_verb"].get(verb, 0.0)
            if not modeled:
                continue
            out[verb] = {"measured": int(measured),
                         "modeled": float(modeled),
                         "ratio": measured / modeled}
        return out

    def server_stats(self, *, drain_trace: bool = False) -> dict:
        """The server process's own counters (one wire round trip).

        ``drain_trace=True`` asks the server to include (and drain) its
        buffered service-time trace spans; old servers ignore the
        request payload, so the key is simply absent."""
        payload = (W.enc_json({"drain_trace": True}) if drain_trace
                   else b"")
        return W.dec_json(self._rpc(W.OP_STATS, payload, verb="stats"))

    def harvest_trace(self) -> int:
        """Drain the server's service-time spans into the local tracer.

        Each harvested span is stitched under the client-side
        ``net.<verb>`` span whose trace context the request carried
        (clocks differ across processes, so the span is re-based to sit
        centered inside its parent — durations are authoritative, wall
        positions are presentational).  Returns the number of spans
        adopted; 0 when tracing is off or the server never acked
        FLAG_TRACE."""
        if not (TRACER.enabled and self._server_trace):
            return 0
        stats = self.server_stats(drain_trace=True)
        ep = f"{self.endpoint[0]}:{self.endpoint[1]}"
        n = 0
        for s in stats.get("trace_spans", ()):
            if int(s.get("trace", 0)) != TRACER.trace_id:
                continue
            parent_id = int(s.get("parent", 0))
            dur = float(s["dur"])
            parent = TRACER.find(parent_id)
            if parent is not None:
                t0 = parent["t0"] + max(parent["dur"] - dur, 0.0) / 2
            else:
                t0 = float(s["t0"])
            TRACER.add_span("server." + s["op"], "server", t0, dur,
                            parent_id=parent_id,
                            attrs={"seq": int(s.get("seq", 0)),
                                   "rx": int(s.get("rx", 0)),
                                   "tx": int(s.get("tx", 0)),
                                   "endpoint": ep, "clock": "server"})
            n += 1
        return n

    def shutdown_server(self) -> None:
        """Ask the server process to exit (harness teardown helper)."""
        try:
            self._rpc(W.OP_SHUTDOWN, verb="shutdown")
        except PoolUnavailableError:
            pass

    def snapshot(self) -> dict:
        """See ``MemoryPool.snapshot``; adds endpoint, fabric, measured
        wire counters, and the wire-vs-model cross-check."""
        from repro_torch.pool.sim_rdma import fabric_params
        out = super().snapshot()
        out["endpoint"] = f"{self.endpoint[0]}:{self.endpoint[1]}"
        out["bearer"] = self.bearer_kind
        out["fabric"] = fabric_params(self.fabric)   # same schema as sim
        out["wire"] = {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in self.wire.items()}
        out["wire_vs_model"] = self.wire_vs_model()
        out["attached_via"] = self.attached_via
        return out
