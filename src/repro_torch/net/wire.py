"""Wire protocol for the MemoryPool verbs — compact binary framing.

Every verb of ``pool/protocol.py`` has a frame: a fixed 20-byte header
(magic, version, opcode, flags, sequence number, payload length) followed
by a verb-specific payload of contiguous numpy buffers.  Descriptor
batches are encoded as flat arrays — ONE doorbell batch is ONE request
frame, so measured frames map 1:1 onto the round trips the ``NetLedger``
model counts.

Payloads are sized so that the *data* verbs carry exactly the bytes the
cost model prices (``protocol.span_wire_bytes`` / ``LayoutSpec``):

* exact span response      — ``m * partition_bytes()`` (graph + vec
  blocks of each span, back to back);
* quantized span response  — ``m * quant_partition_bytes(include_graph)``
  (int8 codes + f32 codebook blocks, plus either the full graph blocks
  or, in scan mode, only the global-id tails: ``np_max + ov_cap`` int32
  per span — the only graph lanes the scan path reads; the client
  rebuilds the span around them, see ``rebuild_quant_gspans``);
* row response             — ``n_rows * row_bytes()``;
* append request           — vector + gid (+ int8 codes + codebook
  scales when the quantized mirror is attached) + the 8-byte partition
  address the WRITE names.

so the ``wire_vs_model`` cross-check in ``client.RemotePool`` can assert
measured-bytes == modeled-bytes instead of trusting the model.

Integers are little-endian; arrays are C-order raw bytes with dtypes
fixed by the protocol.  Decoders copy out of the receive buffer so the
returned arrays are owned and writable.
"""
from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from repro_torch.core.layout import META_COLS, MT_SIDE, LayoutSpec, Store

MAGIC = b"dHNW"
VERSION = 1

# header: magic(4) version(1) opcode(1) flags(2) seq(4) payload_len(8)
HEADER = struct.Struct("<4sBBHIQ")
HEADER_BYTES = HEADER.size

# opcodes
OP_PING = 1
OP_ATTACH = 2            # upload a full region (build / adopt)
OP_ATTACH_QUANT = 3      # upload the int8 + codebook mirror
OP_READ_SPANS = 4
OP_READ_ROWS = 5
OP_READ_QUANT_ROWS = 6
OP_READ_META = 7
OP_APPEND = 8            # one-sided WRITE into a shared overflow region
OP_WRITE_BLOCKS = 9      # block-granular region write (repack / migration)
OP_STATS = 10
OP_SHUTDOWN = 11

OP_NAMES = {
    OP_PING: "ping", OP_ATTACH: "attach", OP_ATTACH_QUANT: "attach_quant",
    OP_READ_SPANS: "read_spans", OP_READ_ROWS: "read_rows",
    OP_READ_QUANT_ROWS: "read_quant_rows", OP_READ_META: "read_meta",
    OP_APPEND: "append", OP_WRITE_BLOCKS: "write_blocks",
    OP_STATS: "stats", OP_SHUTDOWN: "shutdown",
}

# flags
FLAG_QUANT = 0x0001      # span/append verbs: quantized mirror involved
FLAG_GRAPH = 0x0002      # quant spans: include the full graph blocks
FLAG_HAS_QUANT = 0x0004  # attach/write_blocks payload carries the mirror
FLAG_TRACE = 0x0008      # request: payload starts with a trace-context
                         # prefix (see enc_trace_ctx); on a PING response
                         # it advertises that the server understands the
                         # prefix (capability negotiation — clients never
                         # send the prefix to servers that did not ack,
                         # so old servers stay byte-compatible)
FLAG_ERROR = 0x8000      # response: payload is a utf-8 error message

_MAX_PAYLOAD = 1 << 36   # decode sanity bound (64 GiB)


class WireError(ValueError):
    """Malformed frame or payload."""


def pack_frame(op: int, payload: bytes = b"", *, flags: int = 0,
               seq: int = 0) -> bytes:
    """Header (20 B) + payload; the unit every byte counter sees."""
    return HEADER.pack(MAGIC, VERSION, op, flags, seq & 0xFFFFFFFF,
                       len(payload)) + payload


def unpack_header(buf: bytes):
    """-> (op, flags, seq, payload_len).  Raises WireError on garbage."""
    if len(buf) != HEADER_BYTES:
        raise WireError(f"short header: {len(buf)} bytes")
    magic, ver, op, flags, seq, length = HEADER.unpack(buf)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise WireError(f"protocol version {ver} != {VERSION}")
    if length > _MAX_PAYLOAD:
        raise WireError(f"payload length {length} over bound")
    return op, flags, seq, length


# --------------------------------------------------------- trace context

# two 8-byte ids (trace id, parent span id) prepended to a request
# payload when FLAG_TRACE is set; the server strips the prefix before
# decoding the verb payload and tags its service-time span with the ids
_TRACE_CTX = struct.Struct("<QQ")
TRACE_CTX_BYTES = _TRACE_CTX.size


def enc_trace_ctx(trace_id: int, span_id: int) -> bytes:
    """Encode the 16-byte FLAG_TRACE request-payload prefix."""
    return _TRACE_CTX.pack(trace_id & 0xFFFFFFFFFFFFFFFF,
                           span_id & 0xFFFFFFFFFFFFFFFF)


def dec_trace_ctx(payload: bytes):
    """Strip the prefix -> ``((trace_id, span_id), verb_payload)``."""
    if len(payload) < TRACE_CTX_BYTES:
        raise WireError("short trace-context prefix")
    tid, sid = _TRACE_CTX.unpack_from(payload, 0)
    return (tid, sid), payload[TRACE_CTX_BYTES:]


# --------------------------------------------------------------- helpers

def _take(payload: bytes, off: int, dtype, shape):
    """Copy one array out of ``payload`` at ``off`` -> (arr, new_off)."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    arr = np.frombuffer(payload, dtype=dtype, count=n, offset=off)
    itemsize = np.dtype(dtype).itemsize
    return arr.reshape(shape).copy(), off + n * itemsize


def _b(arr, dtype) -> bytes:
    return np.ascontiguousarray(arr, dtype=dtype).tobytes()


_SPEC = struct.Struct("<7q")


def enc_spec(spec: LayoutSpec) -> bytes:
    """LayoutSpec as seven little-endian i64 (56 B, fixed)."""
    return _SPEC.pack(spec.dim, spec.deg, spec.np_max, spec.ov_cap,
                      spec.slot_vecs, spec.n_partitions, spec.quant_group)


def dec_spec(payload: bytes, off: int = 0):
    """-> (LayoutSpec, new_off); inverse of ``enc_spec``."""
    vals = _SPEC.unpack_from(payload, off)
    spec = LayoutSpec(dim=vals[0], deg=vals[1], np_max=vals[2],
                      ov_cap=vals[3], slot_vecs=vals[4], n_partitions=vals[5],
                      quant_group=vals[6])
    return spec, off + _SPEC.size


# --------------------------------------------------------------- attach

def enc_attach(store: Store):
    """Full region upload -> (payload, flags)."""
    spec = store.spec
    parts = [enc_spec(spec), _b(store.n_base, np.int32),
             _b(store.meta_table, np.int32), _b(store.graph_buf, np.int32),
             _b(store.vec_buf, np.float32)]
    flags = 0
    if store.qvec_buf is not None:
        flags |= FLAG_HAS_QUANT
        parts += [_b(store.qvec_buf, np.int8),
                  _b(store.qscale_buf, np.float32)]
    return b"".join(parts), flags


def dec_attach(payload: bytes, flags: int) -> Store:
    """Rebuild a full owned ``Store`` from an attach payload."""
    spec, off = dec_spec(payload)
    P, nb = spec.n_partitions, spec.n_blocks
    n_base, off = _take(payload, off, np.int32, (P,))
    meta, off = _take(payload, off, np.int32, (P, META_COLS))
    graph, off = _take(payload, off, np.int32, (nb, spec.gblk))
    vec, off = _take(payload, off, np.float32, (nb, spec.vblk))
    qv = qs = None
    if flags & FLAG_HAS_QUANT:
        qv, off = _take(payload, off, np.int8, (nb, spec.vblk))
        qs, off = _take(payload, off, np.float32, (nb, spec.n_qgroups))
    if off != len(payload):
        raise WireError(f"attach payload trailing {len(payload) - off} B")
    return Store(spec=spec, graph_buf=graph, vec_buf=vec, meta_table=meta,
                 n_base=n_base, qvec_buf=qv, qscale_buf=qs)


def enc_attach_quant(store: Store) -> bytes:
    """Quantized-mirror upload: spec + int8 codes + f32 codebooks."""
    return b"".join([enc_spec(store.spec), _b(store.qvec_buf, np.int8),
                     _b(store.qscale_buf, np.float32)])


def dec_attach_quant(payload: bytes):
    """-> (spec, qvec_buf, qscale_buf)."""
    spec, off = dec_spec(payload)
    qv, off = _take(payload, off, np.int8, (spec.n_blocks, spec.vblk))
    qs, off = _take(payload, off, np.float32,
                    (spec.n_blocks, spec.n_qgroups))
    if off != len(payload):
        raise WireError("attach_quant payload size mismatch")
    return spec, qv, qs


# ---------------------------------------------------------------- spans

def enc_pids(pids) -> bytes:
    """One descriptor batch: u32 count + i64 partition ids."""
    pids = np.asarray(pids, np.int64).reshape(-1)
    return struct.pack("<I", len(pids)) + _b(pids, np.int64)


def dec_pids(payload: bytes) -> np.ndarray:
    """Inverse of ``enc_pids`` -> i64 partition ids."""
    (n,) = struct.unpack_from("<I", payload, 0)
    arr, off = _take(payload, 4, np.int64, (n,))
    if off != len(payload):
        raise WireError("pid batch size mismatch")
    return arr


def gid_tail_offsets(spec: LayoutSpec, side: int):
    """Flat offsets of the two global-id runs inside one span's graph
    blocks (``fetch_blocks * gblk`` int32): the base-gid tail of the data
    region and the overflow gid run — the only graph lanes the scan-mode
    quant path reads (``device_store.decode_quant_span``)."""
    data_off = side * spec.ov_blocks * spec.gblk + spec.np_max * spec.deg
    ov_off = (1 - side) * spec.data_blocks * spec.gblk
    return data_off, ov_off


def extract_gid_tails(spec: LayoutSpec, g_spans: np.ndarray,
                      sides) -> np.ndarray:
    """(m, fetch_blocks, gblk) graph spans -> (m, np_max + ov_cap) i32."""
    m = g_spans.shape[0]
    out = np.empty((m, spec.np_max + spec.ov_cap), np.int32)
    flat = g_spans.reshape(m, -1)
    for i in range(m):
        d, o = gid_tail_offsets(spec, int(sides[i]))
        out[i, :spec.np_max] = flat[i, d:d + spec.np_max]
        out[i, spec.np_max:] = flat[i, o:o + spec.ov_cap]
    return out


def rebuild_quant_gspans(spec: LayoutSpec, tails: np.ndarray,
                         sides) -> np.ndarray:
    """Inverse of ``extract_gid_tails``: scatter the id runs back into
    -1-filled graph spans.  Adjacency lanes are NOT reconstructed (the
    scan path never reads them); graph-mode quant fetches ship the full
    blocks instead (FLAG_GRAPH)."""
    m = tails.shape[0]
    flat = np.full((m, spec.fetch_blocks * spec.gblk), -1, np.int32)
    for i in range(m):
        d, o = gid_tail_offsets(spec, int(sides[i]))
        flat[i, d:d + spec.np_max] = tails[i, :spec.np_max]
        flat[i, o:o + spec.ov_cap] = tails[i, spec.np_max:]
    return flat.reshape(m, spec.fetch_blocks, spec.gblk)


def enc_spans_resp(spec: LayoutSpec, *, quant: bool, graph: bool = True,
                   g: Optional[np.ndarray] = None,
                   v: Optional[np.ndarray] = None,
                   qv: Optional[np.ndarray] = None,
                   qs: Optional[np.ndarray] = None,
                   tails: Optional[np.ndarray] = None) -> bytes:
    """Span READ response; payload bytes == the modeled span bytes."""
    if not quant:
        return _b(g, np.int32) + _b(v, np.float32)
    parts = [_b(qv, np.int8), _b(qs, np.float32)]
    parts.append(_b(g, np.int32) if graph else _b(tails, np.int32))
    return b"".join(parts)


def dec_spans_resp(spec: LayoutSpec, payload: bytes, *, m: int, quant: bool,
                   graph: bool = True):
    """-> (g, v) exact | (qv, qs, g) quant+graph | (qv, qs, tails)."""
    fb = spec.fetch_blocks
    off = 0
    if not quant:
        g, off = _take(payload, off, np.int32, (m, fb, spec.gblk))
        v, off = _take(payload, off, np.float32, (m, fb, spec.vblk))
        if off != len(payload):
            raise WireError("span response size mismatch")
        return g, v
    qv, off = _take(payload, off, np.int8, (m, fb, spec.vblk))
    qs, off = _take(payload, off, np.float32, (m, fb, spec.n_qgroups))
    if graph:
        g, off = _take(payload, off, np.int32, (m, fb, spec.gblk))
        tail = g
    else:
        tail, off = _take(payload, off, np.int32,
                          (m, spec.np_max + spec.ov_cap))
    if off != len(payload):
        raise WireError("quant span response size mismatch")
    return qv, qs, tail


# ----------------------------------------------------------------- rows

def enc_rows(rows) -> bytes:
    """Row-READ descriptor batch: u32 count + i64 row addresses."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    return struct.pack("<I", len(rows)) + _b(rows, np.int64)


dec_rows = dec_pids      # identical encoding: u32 count + i64 addresses


def enc_rows_resp(vrows: np.ndarray) -> bytes:
    """Row READ response: exactly ``n_rows * row_bytes()`` f32."""
    return _b(vrows, np.float32)


def dec_rows_resp(payload: bytes, n: int, dim: int) -> np.ndarray:
    """-> (n, dim) f32 rows; inverse of ``enc_rows_resp``."""
    arr, off = _take(payload, 0, np.float32, (n, dim))
    if off != len(payload):
        raise WireError("rows response size mismatch")
    return arr


def enc_quant_rows_resp(codes: np.ndarray, scales: np.ndarray) -> bytes:
    """Quant row response: int8 codes + f32 group scales, the modeled
    ``quant_row_bytes()`` per row."""
    return _b(codes, np.int8) + _b(scales, np.float32)


def dec_quant_rows_resp(payload: bytes, n: int, dim: int, group: int):
    """-> (codes (n, dim) i8, scales (n, dim/group) f32)."""
    codes, off = _take(payload, 0, np.int8, (n, dim))
    scales, off = _take(payload, off, np.float32, (n, dim // group))
    if off != len(payload):
        raise WireError("quant rows response size mismatch")
    return codes, scales


# --------------------------------------------------------------- append

_APPEND_HDR = struct.Struct("<qq")   # gid, pid


def enc_append(vec: np.ndarray, gid: int, pid: int,
               codes: Optional[np.ndarray] = None,
               scales: Optional[np.ndarray] = None):
    """One-sided WRITE -> (payload, flags).  Payload = the modeled wire
    bytes (vec + 8B id [+ codes + codebook scales]) plus the 8-byte
    partition address the descriptor names."""
    parts = [_APPEND_HDR.pack(gid, pid), _b(vec, np.float32)]
    flags = 0
    if codes is not None:
        flags |= FLAG_QUANT
        parts += [_b(codes, np.int8), _b(scales, np.float32)]
    return b"".join(parts), flags


def dec_append(payload: bytes, flags: int, dim: int, group: int):
    """-> (vec, gid, pid, codes | None, scales | None)."""
    gid, pid = _APPEND_HDR.unpack_from(payload, 0)
    off = _APPEND_HDR.size
    vec, off = _take(payload, off, np.float32, (dim,))
    codes = scales = None
    if flags & FLAG_QUANT:
        codes, off = _take(payload, off, np.int8, (dim,))
        scales, off = _take(payload, off, np.float32, (dim // group,))
    if off != len(payload):
        raise WireError("append payload size mismatch")
    return vec, int(gid), int(pid), codes, scales


def enc_append_resp(slot: int) -> bytes:
    """Append acknowledgment: the i64 overflow slot the WRITE landed in."""
    return struct.pack("<q", slot)


def dec_append_resp(payload: bytes) -> int:
    """-> overflow slot index from an append response."""
    return struct.unpack("<q", payload)[0]


# --------------------------------------------------- block writes / meta

def enc_write_blocks(store: Store, block_ids):
    """Block-granular region WRITE (repack result / migration landing):
    block ids + their graph/vec (+ mirror) bytes + the metadata table, so
    the receiving node's counters stay coherent with the sender's."""
    ids = np.asarray(block_ids, np.int64).reshape(-1)
    parts = [struct.pack("<I", len(ids)), _b(ids, np.int64),
             _b(store.graph_buf[ids], np.int32),
             _b(store.vec_buf[ids], np.float32)]
    flags = 0
    if store.qvec_buf is not None:
        flags |= FLAG_HAS_QUANT
        parts += [_b(store.qvec_buf[ids], np.int8),
                  _b(store.qscale_buf[ids], np.float32)]
    parts += [_b(store.n_base, np.int32), _b(store.meta_table, np.int32)]
    return b"".join(parts), flags


def dec_write_blocks(payload: bytes, flags: int, spec: LayoutSpec):
    """-> dict(ids, g, v, qv, qs, n_base, meta)."""
    (n,) = struct.unpack_from("<I", payload, 0)
    off = 4
    ids, off = _take(payload, off, np.int64, (n,))
    g, off = _take(payload, off, np.int32, (n, spec.gblk))
    v, off = _take(payload, off, np.float32, (n, spec.vblk))
    qv = qs = None
    if flags & FLAG_HAS_QUANT:
        qv, off = _take(payload, off, np.int8, (n, spec.vblk))
        qs, off = _take(payload, off, np.float32, (n, spec.n_qgroups))
    P = spec.n_partitions
    n_base, off = _take(payload, off, np.int32, (P,))
    meta, off = _take(payload, off, np.int32, (P, META_COLS))
    if off != len(payload):
        raise WireError("write_blocks payload size mismatch")
    return {"ids": ids, "g": g, "v": v, "qv": qv, "qs": qs,
            "n_base": n_base, "meta": meta}


def enc_meta_resp(store: Store) -> bytes:
    """Metadata READ response: the full meta table + per-partition base
    counts (the client refreshes its cached copy wholesale)."""
    return _b(store.meta_table, np.int32) + _b(store.n_base, np.int32)


def dec_meta_resp(payload: bytes, n_partitions: int):
    """-> (meta_table, n_base); inverse of ``enc_meta_resp``."""
    meta, off = _take(payload, 0, np.int32, (n_partitions, META_COLS))
    n_base, off = _take(payload, off, np.int32, (n_partitions,))
    if off != len(payload):
        raise WireError("meta response size mismatch")
    return meta, n_base


# ---------------------------------------------------------- json / misc

def enc_json(obj) -> bytes:
    """Control-plane payload (stats/errors): utf-8 JSON, never priced."""
    return json.dumps(obj).encode("utf-8")


def dec_json(payload: bytes):
    """Inverse of ``enc_json``."""
    return json.loads(payload.decode("utf-8"))


def span_sides(meta_table: np.ndarray, pids) -> np.ndarray:
    """Per-span MT_SIDE lookup shared by the two tail codecs' callers."""
    return meta_table[np.asarray(pids, np.int64), MT_SIDE]


# ------------------------------------------------------- socket helpers

def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError (clean EOF
    included — a vanished peer must never look like a short frame)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock, op: int, payload: bytes = b"", *, flags: int = 0,
               seq: int = 0) -> int:
    """Pack + sendall one frame -> total bytes written (header included),
    which is what the ``bytes_tx`` wire counter records."""
    buf = pack_frame(op, payload, flags=flags, seq=seq)
    sock.sendall(buf)
    return len(buf)


def recv_frame(sock):
    """-> (op, flags, seq, payload)."""
    op, flags, seq, length = unpack_header(recv_exact(sock, HEADER_BYTES))
    payload = recv_exact(sock, length) if length else b""
    return op, flags, seq, payload
