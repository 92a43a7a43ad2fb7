"""PoolServer — a standalone memory-pool node process.

Hosts one serialized region (``core/layout.Store``, host numpy buffers)
and serves every ``MemoryPool`` verb over TCP using the ``wire.py``
framing.  The data plane is deliberately jax-free AND verb-free on the
read side: the region is *registered* as a set of memory-region windows
(``repro.rdma.mr.host_mrs`` — span / row / quant-row numpy views keyed
by rkey), and a read frame is answered by delegating the address batch
to the MR its opcode names — one generic dispatch line per read opcode,
no per-verb server logic, exactly like the paper's passive memory nodes
that own bytes and nothing else.  Appends are ``layout.insert_vector``
host writes; the *compute* side (RemotePool's caller) owns all device
work.

Run standalone:

    python -m repro.net.server --port 0        # auto-pick, prints port

or embed (``PoolServer(region=...).start()``) — tests and benchmarks use
``spawn_pool_servers(n)`` to fork n loopback servers and tear them down
with a timeout.

Concurrency: a threaded accept loop, one handler thread per connection,
requests on a connection answered strictly in order (the client
pipelines doorbell batches by writing k frames before reading k
responses).  A region-wide lock serializes verb bodies — the region is
the shared state, and numpy gathers are fast enough that per-verb
locking is not the bottleneck at this scale.

The server starts EMPTY: a client uploads the region with an ATTACH
frame (the offline "load the index into the memory pool" step; repeated
ATTACH replaces the region — one region per server).  ``--demo-n``
pre-builds a synthetic region (seeded by ``--seed``) for standalone
poking without a client build.

Durability (``--data-dir``): every mutating verb is appended to a WAL
before its ack and the region is checkpointed on a cadence
(``repro.ingest``); on restart the server recovers checkpoint + WAL
tail and resumes serving the identical region — memory-pool state now
survives the process, so failover can rejoin a recovered server instead
of re-replicating from the host region.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import threading
import time
import zlib
from collections import Counter, deque

import numpy as np

from repro_torch.core import layout as LA
from repro_torch.net import wire as W
from repro_torch.rdma import mr as RM
from repro_torch.rdma import verbs as V

#: verbs that change region state — exactly the set the WAL captures
MUTATING_OPS = frozenset({W.OP_ATTACH, W.OP_ATTACH_QUANT, W.OP_APPEND,
                          W.OP_WRITE_BLOCKS})


class HostRegion:
    """The server-side region + verb handlers (pure numpy)."""

    #: bound on buffered server-side trace spans (oldest dropped first)
    TRACE_CAP = 4096

    def __init__(self, store=None, durability=None):
        self.store = store
        self.durability = durability
        # registered memory regions: rkey -> numpy window onto the
        # store; read frames are answered by delegating to these, so
        # the server has no per-verb read logic.  MRs dereference
        # ``self.store`` per read — ATTACH replacement and in-place
        # mutation are both immediately visible.
        self.mrs = RM.host_mrs(self)
        self.lock = threading.RLock()
        self.verbs: Counter = Counter()
        self.payload_tx = 0      # response payload bytes served
        self.payload_rx = 0      # request payload bytes received
        self.t0 = time.time()
        # per-verb service time (seconds inside the verb body, always
        # on) and the service-time spans recorded for FLAG_TRACE
        # requests, drained by a stats({"drain_trace": true}) call
        self.service_s: Counter = Counter()
        # per-verb service-time histograms (mergeable log buckets) — the
        # server-side tail view a STATS drain ships to the compute node
        from repro_torch.obs.hist import LatencyHistogram
        self.service_hist: dict = {}
        self._hist_cls = LatencyHistogram
        self.trace_spans: deque = deque(maxlen=self.TRACE_CAP)

    # ------------------------------------------------------------ durability

    def attach_durability(self, dur) -> None:
        """Recover from ``dur``'s data-dir and log all future mutations.

        Loads the checkpoint (if any), replays the committed WAL tail
        through the normal handler table (replay is never re-logged),
        and folds a non-empty tail into a fresh checkpoint so the next
        restart starts from a shorter log.
        """
        from repro_torch.obs.trace import TRACER
        self.durability = dur
        store, tail = dur.recover()
        if store is not None:
            self.store = store
        if tail:
            t0 = time.perf_counter()
            with dur.replay_guard():
                for rec in tail:
                    self.handle(rec.op, rec.flags, rec.payload)
            if TRACER.enabled:
                TRACER.add("ingest.replay", "ingest", t0,
                           time.perf_counter() - t0, records=len(tail))
            if self.store is not None:
                dur.checkpoint(self.store)

    def fingerprint(self) -> dict:
        """Cheap region identity for the recovery handshake: geometry +
        a CRC over the metadata table and base counts (the mutable
        directory every verb goes through)."""
        st = self._require()
        crc = zlib.crc32(st.meta_table.tobytes())
        crc = zlib.crc32(st.n_base.tobytes(), crc)
        return {"n_blocks": int(st.spec.n_blocks),
                "n_partitions": int(st.spec.n_partitions),
                "n_base": int(st.n_base.sum()), "crc": int(crc)}

    # ------------------------------------------------------------ helpers

    def _require(self):
        if self.store is None:
            raise RuntimeError("no region attached")
        return self.store

    # ------------------------------------------------------------ verbs

    def attach(self, payload, flags):
        """Adopt a full uploaded region as this node's source of truth."""
        self.store = W.dec_attach(payload, flags)
        return b"", 0

    def attach_quant(self, payload, flags):
        """Adopt an uploaded int8 + codebook mirror of the region."""
        store = self._require()
        spec, qv, qs = W.dec_attach_quant(payload)
        if spec.quant_group != store.spec.quant_group:
            import dataclasses as DC
            store.spec = DC.replace(store.spec,
                                    quant_group=spec.quant_group)
        store.qvec_buf, store.qscale_buf = qv, qs
        return b"", 0

    def read_spans(self, payload, flags):
        """One-sided span READ: delegate to the registered span MR."""
        return self.mrs[V.RKEY_SPANS].read(payload, flags)

    def read_rows(self, payload, flags):
        """One-sided row READ: delegate to the registered row MR."""
        return self.mrs[V.RKEY_ROWS].read(payload, flags)

    def read_quant_rows(self, payload, flags):
        """One-sided quant-row READ: delegate to the mirror's row MR."""
        return self.mrs[V.RKEY_QROWS].read(payload, flags)

    def read_meta(self, payload, flags):
        """Ship the metadata table + base counts (client cache refresh)."""
        return W.enc_meta_resp(self._require()), 0

    def append(self, payload, flags):
        """Land a one-sided WRITE in the named partition's overflow
        region; replies with the slot so the client can cross-check its
        mirror ran the identical deterministic insert."""
        store = self._require()
        spec = store.spec
        vec, gid, pid, codes, scales = W.dec_append(
            payload, flags, spec.dim, spec.quant_group or 1)
        slot = LA.insert_vector(store, vec, gid, pid)
        if slot >= 0 and store.qvec_buf is not None:
            # mirror twin of the WRITE: the client shipped the quantized
            # row; a deterministic block refresh from the f32 region
            # yields the same bytes, which keeps both paths honest
            group = int(store.meta_table[pid, LA.MT_GROUP])
            co = LA.overflow_write_coords(spec, group, slot)
            LA.refresh_quant_blocks(store, [co["vec_block"]])
        return W.enc_append_resp(slot), 0

    def write_blocks(self, payload, flags):
        """Block-granular region WRITE (repack result / migration /
        replica sync): overwrite the named blocks + metadata."""
        store = self._require()
        upd = W.dec_write_blocks(payload, flags, store.spec)
        ids = upd["ids"]
        store.graph_buf[ids] = upd["g"]
        store.vec_buf[ids] = upd["v"]
        if upd["qv"] is not None:
            if store.qvec_buf is None:
                raise RuntimeError("mirror blocks for an unattached mirror")
            store.qvec_buf[ids] = upd["qv"]
            store.qscale_buf[ids] = upd["qs"]
        store.n_base[:] = upd["n_base"]
        store.meta_table[:] = upd["meta"]
        return b"", 0

    def stats(self, payload, flags):
        """Control-plane JSON: verb counts, payload totals, per-verb
        service seconds, region info.  A ``{"drain_trace": true}``
        request payload additionally returns (and drains) the buffered
        server-side trace spans — old servers ignore the payload, so the
        extension is backward-compatible in both directions."""
        req = {}
        if payload:
            try:
                req = W.dec_json(payload)
            except Exception:
                req = {}
        out = {"verbs": dict(self.verbs),
               "payload_tx": self.payload_tx,
               "payload_rx": self.payload_rx,
               "service_s": {k: float(v) for k, v in self.service_s.items()},
               "service_hist": {k: h.to_dict()
                                for k, h in sorted(self.service_hist.items())},
               "uptime_s": round(time.time() - self.t0, 3),
               "attached": self.store is not None}
        if self.store is not None:
            out["n_partitions"] = int(self.store.spec.n_partitions)
            out["region_bytes"] = int(self.store.total_bytes())
            out["quant_attached"] = self.store.qvec_buf is not None
            out["region_fingerprint"] = self.fingerprint()
        if self.durability is not None:
            out["ingest"] = self.durability.stats()
        if req.get("drain_trace"):
            out["trace_spans"] = list(self.trace_spans)
            self.trace_spans.clear()
        return W.enc_json(out), 0

    # ------------------------------------------------------------ dispatch

    HANDLERS = {
        W.OP_ATTACH: attach, W.OP_ATTACH_QUANT: attach_quant,
        W.OP_READ_SPANS: read_spans, W.OP_READ_ROWS: read_rows,
        W.OP_READ_QUANT_ROWS: read_quant_rows, W.OP_READ_META: read_meta,
        W.OP_APPEND: append, W.OP_WRITE_BLOCKS: write_blocks,
        W.OP_STATS: stats,
    }

    def handle(self, op: int, flags: int, payload: bytes, seq: int = 0):
        """One verb -> (response_payload, response_flags)."""
        tctx = None
        if flags & W.FLAG_TRACE:
            # strip the trace-context prefix before the verb decoder
            # sees the payload; the ids tag this verb's service span
            tctx, payload = W.dec_trace_ctx(payload)
            flags &= ~W.FLAG_TRACE
        if op == W.OP_PING:
            # ping response advertises trace-context support — clients
            # only ever send the prefix to servers that acked it here
            return payload, W.FLAG_TRACE
        fn = self.HANDLERS.get(op)
        if fn is None:
            raise RuntimeError(f"unknown opcode {op}")
        name = W.OP_NAMES.get(op, str(op))
        with self.lock:
            self.verbs[name] += 1
            self.payload_rx += len(payload)
            t0 = time.perf_counter()
            resp, rflags = fn(self, payload, flags)
            if (op in MUTATING_OPS and self.durability is not None
                    and not self.durability.replaying):
                # WAL before ack: the handler already mutated the
                # region, but the client only sees success once the
                # record is down; a crash in between replays it.
                self.durability.log(op, flags, payload)
                self.durability.maybe_checkpoint(self.store)
            dur = time.perf_counter() - t0
            self.service_s[name] += dur
            h = self.service_hist.get(name)
            if h is None:
                h = self.service_hist[name] = self._hist_cls()
            h.record(dur)
            self.payload_tx += len(resp)
            if tctx is not None:
                self.trace_spans.append(
                    {"op": name, "trace": int(tctx[0]),
                     "parent": int(tctx[1]), "seq": int(seq),
                     "t0": t0, "dur": dur,
                     "rx": len(payload), "tx": len(resp)})
            return resp, rflags


class PoolServer:
    """Threaded TCP front-end around one ``HostRegion``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 region: HostRegion | None = None):
        self.region = region or HostRegion()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(32)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        """``host:port`` actually bound (port 0 resolves at bind)."""
        return f"{self.host}:{self.port}"

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "PoolServer":
        """Serve in a daemon thread; returns self for chaining."""
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"poolserver-{self.port}")
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread until ``stop()`` (CLI mode)."""
        self._accept_loop()

    def stop(self) -> None:
        """Stop accepting and close the listener (idempotent)."""
        self._stop.set()
        with contextlib.suppress(OSError):
            self._lsock.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                break                      # listener closed
            # daemon handler threads are not tracked: they exit with
            # their connection, and a long-lived server must not grow a
            # list entry per client that ever connected
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                try:
                    op, flags, seq, payload = W.recv_frame(conn)
                except (ConnectionError, OSError, W.WireError):
                    return                 # client went away / garbage
                if op == W.OP_SHUTDOWN:
                    W.send_frame(conn, op, b"", seq=seq)
                    self.stop()
                    return
                try:
                    resp, rflags = self.region.handle(op, flags, payload,
                                                      seq)
                except Exception as e:     # verb error -> error frame
                    resp = str(e).encode("utf-8")
                    rflags = W.FLAG_ERROR
                try:
                    W.send_frame(conn, op, resp, flags=rflags, seq=seq)
                except (ConnectionError, OSError):
                    return
        finally:
            with contextlib.suppress(OSError):
                conn.close()


# ------------------------------------------------------------- harness

def _src_path() -> str:
    import repro_torch
    # repro may be a namespace package (no __init__.py): use __path__
    pkg_dir = (os.path.dirname(repro_torch.__file__) if repro_torch.__file__
               else next(iter(repro_torch.__path__)))
    return os.path.dirname(os.path.abspath(pkg_dir))


@contextlib.contextmanager
def spawn_pool_servers(n: int = 1, *, host: str = "127.0.0.1", seed: int = 0,
                       startup_timeout_s: float = 60.0, demo_n: int = 0,
                       with_procs: bool = False, data_dirs=None,
                       checkpoint_every: int = 0):
    """Fork ``n`` loopback pool-server processes; yield their endpoints.

    Each server binds ``--port 0`` (OS-assigned — no CI port clashes) and
    announces ``POOLSERVER LISTENING host port`` on stdout; teardown
    sends SIGTERM and escalates to SIGKILL after a timeout, so a hung
    server can never wedge a test run.

    ``with_procs=True`` yields ``(endpoints, procs)`` instead — the
    ``subprocess.Popen`` handles let chaos tests and benchmarks kill -9
    individual servers mid-run to exercise the failover path; teardown
    copes with already-dead processes.

    ``data_dirs`` (one directory per server) makes the servers durable:
    each runs with ``--data-dir`` (WAL + checkpoints, recovery on
    restart); ``checkpoint_every`` overrides the snapshot cadence.
    """
    assert data_dirs is None or len(data_dirs) == n, data_dirs
    env = os.environ.copy()
    src = _src_path()
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    procs, endpoints, drains = [], [], []
    try:
        for i in range(n):
            cmd = [sys.executable, "-m", "repro_torch.net.server", "--host", host,
                   "--port", "0", "--seed", str(seed + i)]
            if demo_n:
                cmd += ["--demo-n", str(demo_n)]
            if data_dirs is not None:
                cmd += ["--data-dir", data_dirs[i]]
                if checkpoint_every:
                    cmd += ["--checkpoint-every", str(checkpoint_every)]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 env=env)
            procs.append(p)
        deadline = time.time() + startup_timeout_s
        for p in procs:
            ep = _await_listening(p, deadline)
            endpoints.append(ep)
            t = threading.Thread(target=_drain, args=(p,), daemon=True)
            t.start()
            drains.append(t)
        yield (endpoints, procs) if with_procs else endpoints
    finally:
        for p in procs:
            with contextlib.suppress(OSError):
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                with contextlib.suppress(subprocess.TimeoutExpired):
                    p.wait(timeout=5)


def _await_listening(p: subprocess.Popen, deadline: float) -> str:
    """Read the announce line with a hard deadline (a crashed server hits
    EOF and reports its captured output instead of hanging)."""
    out: list[str] = []
    result: list = []

    def reader():
        for line in p.stdout:
            out.append(line)
            if line.startswith("POOLSERVER LISTENING"):
                _, _, h, prt = line.split()
                result.append(f"{h}:{prt}")
                return
        result.append(None)               # EOF before announce

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(max(deadline - time.time(), 0.1))
    if not result or result[0] is None:
        with contextlib.suppress(OSError):
            p.kill()
        raise RuntimeError("pool server failed to start:\n" + "".join(out))
    return result[0]


def _drain(p: subprocess.Popen) -> None:
    """Keep consuming server stdout so a chatty server can't fill the
    pipe and block."""
    with contextlib.suppress(Exception):
        for _ in p.stdout:
            pass


def _build_demo_region(n: int, seed: int) -> HostRegion:
    from repro_torch.core.hnsw import HNSWParams
    from repro_torch.core.meta import build_meta
    from repro_torch.data.synthetic import sift_like
    ds = sift_like(n=n, n_queries=8, seed=seed)
    meta = build_meta(ds.data, max(8, n // 128), seed=seed, meta_levels=2)
    store = LA.build_store(ds.data, meta,
                           sub_params=HNSWParams(M=8, M0=16,
                                                 ef_construction=60))
    return HostRegion(store)


def main(argv=None) -> int:
    """CLI entry point: host one memory-pool node (see --help)."""
    ap = argparse.ArgumentParser(
        description="d-HNSW memory-pool node: host a region, serve "
                    "MemoryPool verbs over TCP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = auto-pick a free port (printed on stdout)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the --demo-n synthetic region")
    ap.add_argument("--demo-n", type=int, default=0,
                    help="pre-build a synthetic region of this many "
                         "vectors (0 = start empty, await ATTACH)")
    ap.add_argument("--data-dir", default=None,
                    help="durable state directory (WAL + checkpoints); "
                         "recovers the region on restart")
    ap.add_argument("--checkpoint-every", type=int, default=256,
                    help="checkpoint after this many logged mutations")
    ap.add_argument("--wal-fsync", action="store_true",
                    help="fsync the WAL on every append (power-loss "
                         "safety; default flushes to the OS only)")
    args = ap.parse_args(argv)
    region = (_build_demo_region(args.demo_n, args.seed) if args.demo_n
              else HostRegion())
    if args.data_dir:
        from repro_torch.ingest import Durability
        region.attach_durability(
            Durability(args.data_dir, checkpoint_every=args.checkpoint_every,
                       fsync=args.wal_fsync))
    srv = PoolServer(args.host, args.port, region=region)
    print(f"POOLSERVER LISTENING {srv.host} {srv.port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
