"""The host parameter-server cluster — the port of ``distributed/ps.py``
(sparse and dense tables over TCP).

The reference trains in two PS regimes: the GPU-resident BoxPS, and the
CPU parameter server behind ``FleetWrapper`` (PullSparseVarsSync,
PushSparseVarsWithLabelAsync, PullDenseVarsAsync, PushDenseVarsAsync,
save/load/shrink). This module is the second:

- :class:`PSServer` — one endpoint (threaded TCP) holding shards of
  sparse tables (a ``HostEmbeddingStore`` each, updated by the same
  in-table optimizer the card's push runs) and dense tables (an
  ``AsyncDenseTable`` each: BoxPSAsynDenseTable's merge/update);
- :class:`PSClient` — the FleetWrapper-shaped client: sparse pull/push,
  dense pull/push, save/load/shrink, stop. Keys are hash-sharded over the
  servers (``key * 0x9E3779B97F4A7C15 mod n``, the JAX package's rule);
  a dense table lives on the server its name's CRC-32 picks (the JAX
  package uses Python's ``hash(name)``, which is salted per process, so
  two trainer processes there can place one table on different servers);
- :class:`RemoteEmbeddingStore` — the ``HostEmbeddingStore`` pass API
  over a PS cluster, so a ``Trainer`` (its ``FeedPassManager``) trains
  on the card against a table the cluster holds. The table is shared,
  so resident reuse is off (``supports_resident_reuse = False``): every
  pass rebuilds from the servers and writes its rows back eagerly.

Wire: an 8-byte little-endian length, then a 4-byte JSON header length,
the JSON header (its ``arrays`` entry gives each array's dtype and
shape) and the arrays' bytes back to back. No pickle. The JAX package's
framing byte for byte, so a port client talks to a JAX server and the
reverse. Every client call has a deadline (``timeout_s``): past it the
socket raises.

``python -m paddlebox_tpu_torch.distributed.ps --port N`` runs one
server (``--port 0`` binds a free port; the first line printed names
it).
"""

from __future__ import annotations

import dataclasses
import json
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.embedding import gating
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.optim import apply_updates
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.parallel.dense_sync import AsyncDenseTable

_MIX = np.uint64(0x9E3779B97F4A7C15)  # Fibonacci mix before modulo sharding


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _pack(header: dict, arrays: Sequence[np.ndarray] = ()) -> bytes:
    header = dict(header)
    header["arrays"] = [{"dtype": str(a.dtype), "shape": list(a.shape)}
                        for a in arrays]
    hb = json.dumps(header).encode()
    parts = [struct.pack("<I", len(hb)), hb]
    parts += [np.ascontiguousarray(a).tobytes() for a in arrays]
    body = b"".join(parts)
    return struct.pack("<Q", len(body)) + body


def _unpack(body: bytes) -> tuple[dict, list[np.ndarray]]:
    hlen = struct.unpack_from("<I", body, 0)[0]
    header = json.loads(body[4:4 + hlen].decode())
    arrays = []
    off = 4 + hlen
    for spec in header.pop("arrays", []):
        dt = np.dtype(spec["dtype"])
        n = int(np.prod(spec["shape"])) if spec["shape"] else 1
        nbytes = dt.itemsize * n
        arr = np.frombuffer(body[off:off + nbytes], dtype=dt)
        arrays.append(arr.reshape(spec["shape"]))
        off += nbytes
    return header, arrays


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket
              ) -> tuple[dict, list[np.ndarray], int] | None:
    """(header, arrays, wire bytes) of one message, None at EOF."""
    head = _recv_exact(sock, 8)
    if head is None:
        return None
    n = struct.unpack("<Q", head)[0]
    body = _recv_exact(sock, n)
    if body is None:
        return None
    header, arrays = _unpack(body)
    return header, arrays, 8 + n


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _SparseTable:
    """One server's shard of a sparse table: a store and its in-table
    optimizer."""

    N_STRIPES = 16

    def __init__(self, cfg: EmbeddingConfig):
        self.cfg = cfg
        self.store = HostEmbeddingStore(cfg)
        # striped push locks: pushers of disjoint keys run in parallel;
        # only same-stripe read-modify-writes serialize (the store's own
        # index lock stays the one global section)
        self._stripe_locks = [threading.Lock()
                              for _ in range(self.N_STRIPES)]

    def pull(self, keys: np.ndarray, init_missing: bool) -> np.ndarray:
        rows = (self.store.lookup_or_init(keys) if init_missing
                else self.store.peek_rows(keys))
        # the pull layout gates absent planes (gating.py); pull_rows, the
        # storage view, does not
        return gating.gate_pull_np(
            np.ascontiguousarray(rows[:, :self.cfg.pull_width]), self.cfg)

    def pull_rows(self, keys: np.ndarray, init_missing: bool) -> np.ndarray:
        return (self.store.lookup_or_init(keys) if init_missing
                else self.store.peek_rows(keys))

    def write_rows(self, keys: np.ndarray, rows: np.ndarray) -> None:
        self.store.lookup_or_init(keys)  # ensure presence
        self.store.write_back(keys, rows)

    def push(self, keys: np.ndarray, grads: np.ndarray, shows: np.ndarray,
             clks: np.ndarray) -> None:
        """Merge duplicate keys, then apply the in-table optimizer (the
        PS side of PushSparseGPU). The merge touches only this push's
        arrays; each stripe's read-modify-write holds its lock."""
        uniq, inv = np.unique(keys, return_inverse=True)
        gw = grads.shape[1]
        m = np.zeros((len(uniq), gw + 2), np.float32)
        np.add.at(m, inv, np.concatenate(
            [grads, shows[:, None], clks[:, None]], axis=1))
        with np.errstate(over="ignore"):
            stripes = ((uniq * _MIX) >> np.uint64(60)).astype(np.int64) \
                % self.N_STRIPES
        for s in np.unique(stripes):
            sel = stripes == s
            ku, mu = uniq[sel], m[sel]
            with self._stripe_locks[s]:
                rows = self.store.lookup_or_init(ku)
                new_rows = apply_updates(
                    torch.from_numpy(np.ascontiguousarray(rows)),
                    torch.from_numpy(np.ascontiguousarray(mu[:, :gw])),
                    torch.from_numpy(np.ascontiguousarray(mu[:, gw])),
                    torch.from_numpy(np.ascontiguousarray(mu[:, gw + 1])),
                    self.cfg)
                self.store.write_back(ku, new_rows.numpy())


class PSServer:
    """One parameter-server endpoint (threaded TCP)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.sparse: dict[str, _SparseTable] = {}
        self.dense: dict[str, AsyncDenseTable] = {}
        self._handlers = {
            "create_sparse": self._h_create_sparse,
            "pull_sparse": self._h_pull_sparse,
            "pull_rows": self._h_pull_rows,
            "write_rows": self._h_write_rows,
            "push_sparse": self._h_push_sparse,
            "create_dense": self._h_create_dense,
            "pull_dense": self._h_pull_dense,
            "push_dense": self._h_push_dense,
            "save": self._h_save,
            "load": self._h_load,
            "shrink": self._h_shrink,
            "stats": self._h_stats,
            "ping": lambda h, a: ({"ok": True}, []),
        }
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    msg = _recv_msg(self.request)
                    if msg is None:
                        return
                    header, arrays, _ = msg
                    cmd = header.get("cmd")
                    if cmd == "stop":
                        self.request.sendall(_pack({"ok": True}))
                        # serve_forever runs on another thread than this
                        # handler's, so shutdown() returns
                        outer._srv.shutdown()
                        outer._stop_tables()
                        return
                    try:
                        rh, ra = outer._handlers[cmd](header, arrays)
                    except Exception as e:  # the error raises client-side
                        rh, ra = {"ok": False, "error": f"{type(e).__name__}:"
                                  f" {e}"}, []
                    self.request.sendall(_pack(rh, ra))

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Srv((host, port), Handler)
        self.host, self.port = self._srv.server_address
        self._thread: threading.Thread | None = None

    # ---- lifecycle ----
    def start(self) -> "PSServer":
        self._thread = mon_ctx.spawn(self._srv.serve_forever,
                                     name=f"pbt-ps-{self.port}")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._srv.serve_forever()
        self._srv.server_close()

    def _stop_tables(self) -> None:
        # the dense tables' updater threads must end with the server
        for t in self.dense.values():
            t.stop()

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._stop_tables()
        if self._thread:
            self._thread.join()

    # ---- handlers ----
    def _h_create_sparse(self, h, a):
        cfg = EmbeddingConfig(**h["cfg"])
        self.sparse.setdefault(h["table"], _SparseTable(cfg))
        return {"ok": True}, []

    def _sparse(self, h) -> _SparseTable:
        t = self.sparse.get(h["table"])
        if t is None:
            raise KeyError(f"sparse table {h['table']!r} not created")
        return t

    def _h_pull_sparse(self, h, a):
        vals = self._sparse(h).pull(a[0], h.get("init", True))
        return {"ok": True}, [vals]

    def _h_pull_rows(self, h, a):
        return {"ok": True}, [self._sparse(h).pull_rows(a[0],
                                                        h.get("init", True))]

    def _h_write_rows(self, h, a):
        self._sparse(h).write_rows(a[0], a[1])
        return {"ok": True}, []

    def _h_push_sparse(self, h, a):
        self._sparse(h).push(a[0], a[1], a[2], a[3])
        return {"ok": True}, []

    def _h_create_dense(self, h, a):
        name = h["name"]
        if name not in self.dense:
            t = AsyncDenseTable(a[0], lr=h.get("lr", 1e-3),
                                merge_limit=h.get("merge_limit", 4))
            t.start()
            self.dense[name] = t
        return {"ok": True}, []

    def _dense(self, h) -> AsyncDenseTable:
        t = self.dense.get(h["name"])
        if t is None:
            raise KeyError(f"dense table {h['name']!r} not created")
        return t

    def _h_pull_dense(self, h, a):
        return {"ok": True}, [self._dense(h).pull()]

    def _h_push_dense(self, h, a):
        self._dense(h).push(a[0])
        return {"ok": True}, []

    def _h_save(self, h, a):
        t = self._sparse(h)
        path = h["path"]
        f = (t.store.save_delta(path) if h.get("mode") == "delta"
             else t.store.save_base(path))
        return {"ok": True, "file": f}, []

    def _h_load(self, h, a):
        t = self._sparse(h)
        t.store = HostEmbeddingStore.load(h["path"], t.cfg)
        return {"ok": True}, []

    def _h_shrink(self, h, a):
        n = self._sparse(h).store.shrink(h["min_show"], h.get("decay", 1.0))
        return {"ok": True, "evicted": n}, []

    def _h_stats(self, h, a):
        return {"ok": True,
                "sparse": {k: len(t.store) for k, t in self.sparse.items()},
                "dense": sorted(self.dense)}, []


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class PSClient:
    """FleetWrapper-shaped client over one or more PSServer endpoints.

    ``io`` counts, per command, the calls, the bytes sent and received
    and the seconds spent waiting (a pass's pull and push traffic is the
    difference of two ``io_snapshot()``s)."""

    def __init__(self, endpoints: Sequence[tuple[str, int]],
                 timeout_s: float = 120.0):
        self.endpoints = [(str(h), int(p)) for h, p in endpoints]
        self.timeout_s = float(timeout_s)
        self._socks: list[socket.socket | None] = [None] * len(self.endpoints)
        self._locks = [threading.Lock() for _ in self.endpoints]
        self._io_lock = threading.Lock()
        self.io: dict[str, dict[str, float]] = {}
        self._async_threads: list[threading.Thread] = []
        self._async_errors: list[BaseException] = []

    @property
    def n_servers(self) -> int:
        return len(self.endpoints)

    # ---- transport ----
    def _sock(self, i: int) -> socket.socket:
        if self._socks[i] is None:
            s = socket.create_connection(self.endpoints[i],
                                         timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[i] = s
        return self._socks[i]

    def _call(self, i: int, header: dict,
              arrays: Sequence[np.ndarray] = ()
              ) -> tuple[dict, list[np.ndarray]]:
        msg = _pack(header, arrays)
        t0 = time.perf_counter()
        with self._locks[i]:
            s = self._sock(i)
            try:
                s.sendall(msg)
                resp = _recv_msg(s)
            except OSError:
                # a timed-out or broken connection carries a half-read
                # reply: never reuse it
                self._drop(i)
                raise
        if resp is None:
            self._drop(i)
            raise ConnectionError(f"server {self.endpoints[i]} closed")
        rh, ra, nbytes = resp
        self._count(header.get("cmd", "?"), len(msg), nbytes,
                    time.perf_counter() - t0)
        if not rh.get("ok", False):
            raise RuntimeError(f"PS {self.endpoints[i]}: "
                               f"{rh.get('error', 'unknown error')}")
        return rh, ra

    def _drop(self, i: int) -> None:
        s, self._socks[i] = self._socks[i], None
        if s is not None:
            s.close()

    def _count(self, cmd: str, sent: int, recv: int, seconds: float) -> None:
        with self._io_lock:
            c = self.io.setdefault(cmd, {"calls": 0, "sent_bytes": 0,
                                         "recv_bytes": 0, "seconds": 0.0})
            c["calls"] += 1
            c["sent_bytes"] += sent
            c["recv_bytes"] += recv
            c["seconds"] += seconds

    def io_snapshot(self) -> dict[str, dict[str, float]]:
        with self._io_lock:
            return {k: dict(v) for k, v in self.io.items()}

    @staticmethod
    def _fanout(fns) -> None:
        """Run thunks on threads; re-raise the first worker exception."""
        errs: list[BaseException] = []

        def guard(fn):
            def run():
                try:
                    fn()
                except BaseException as e:
                    errs.append(e)
            return run
        ts = [mon_ctx.spawn(guard(fn), daemon=False) for fn in fns]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]

    def _all(self, header: dict, arrays: Sequence[np.ndarray] = ()):
        outs = [None] * self.n_servers

        def one(i):
            outs[i] = self._call(i, header, arrays)
        self._fanout([lambda i=i: one(i) for i in range(self.n_servers)])
        return outs

    def _owner_of(self, keys: np.ndarray) -> np.ndarray:
        with np.errstate(over="ignore"):
            return ((keys.astype(np.uint64) * _MIX)
                    % np.uint64(self.n_servers)).astype(np.int64)

    def _dense_owner(self, name: str) -> int:
        return zlib.crc32(name.encode()) % self.n_servers

    # ---- sparse (PullSparseVarsSync / PushSparseVarsWithLabelAsync) ----
    def create_sparse_table(self, table: str, cfg: EmbeddingConfig) -> None:
        self._all({"cmd": "create_sparse", "table": table,
                   "cfg": dataclasses.asdict(cfg)})

    def _scatter(self, keys: np.ndarray) -> list[np.ndarray]:
        owner = self._owner_of(keys)
        return [np.nonzero(owner == i)[0] for i in range(self.n_servers)]

    def pull_sparse(self, table: str, keys: np.ndarray,
                    init_missing: bool = True, rows: bool = False
                    ) -> np.ndarray:
        """Each key's pull-layout values (``rows``: its whole stored row),
        gathered from the servers that own them, in ``keys`` order."""
        keys = np.asarray(keys, dtype=np.uint64)
        parts = self._scatter(keys)
        cmd = "pull_rows" if rows else "pull_sparse"
        outs: list[np.ndarray | None] = [None] * self.n_servers

        def one(i):
            if len(parts[i]) == 0:
                return
            _, ra = self._call(i, {"cmd": cmd, "table": table,
                                   "init": init_missing}, [keys[parts[i]]])
            outs[i] = ra[0]
        self._fanout([lambda i=i: one(i) for i in range(self.n_servers)])
        if all(o is None for o in outs):  # only when keys is empty
            return np.zeros((0, 0), np.float32)
        width = next(o.shape[1] for o in outs if o is not None)
        res = np.zeros((len(keys), width), np.float32)
        for i, o in enumerate(outs):
            if o is not None:
                res[parts[i]] = o
        return res

    def push_sparse(self, table: str, keys: np.ndarray, grads: np.ndarray,
                    shows: np.ndarray, clks: np.ndarray,
                    wait: bool = True) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        grads = np.asarray(grads, dtype=np.float32)
        shows = np.asarray(shows, dtype=np.float32)
        clks = np.asarray(clks, dtype=np.float32)
        parts = self._scatter(keys)

        def one(i):
            if len(parts[i]) == 0:
                return
            p = parts[i]
            self._call(i, {"cmd": "push_sparse", "table": table},
                       [keys[p], grads[p], shows[p], clks[p]])
        if wait:
            self._fanout([lambda i=i: one(i)
                          for i in range(self.n_servers)])
            return

        # PushSparseVarsWithLabelAsync: fire, and flush() joins and
        # raises what failed
        def guarded(i):
            try:
                one(i)
            except BaseException as e:
                self._async_errors.append(e)
        ts = [mon_ctx.spawn(guarded, args=(i,), daemon=False)
              for i in range(self.n_servers)]
        for t in ts:
            t.start()
        self._async_threads += ts

    def write_rows(self, table: str, keys: np.ndarray,
                   rows: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        rows = np.asarray(rows, dtype=np.float32)
        parts = self._scatter(keys)

        def one(i):
            if len(parts[i]):
                self._call(i, {"cmd": "write_rows", "table": table},
                           [keys[parts[i]], rows[parts[i]]])
        self._fanout([lambda i=i: one(i) for i in range(self.n_servers)])

    def flush(self) -> None:
        """Join the async pushes (the role of FleetWrapper's sparse-push
        wait groups); the first one that failed raises here."""
        for t in self._async_threads:
            t.join()
        self._async_threads.clear()
        if self._async_errors:
            err, self._async_errors = self._async_errors[0], []
            raise err

    # ---- dense (PullDenseVarsAsync / PushDenseVarsAsync) ----
    def create_dense_table(self, name: str, init: np.ndarray,
                           lr: float = 1e-3, merge_limit: int = 4) -> None:
        self._call(self._dense_owner(name),
                   {"cmd": "create_dense", "name": name, "lr": lr,
                    "merge_limit": merge_limit},
                   [np.asarray(init, np.float32)])

    def pull_dense(self, name: str) -> np.ndarray:
        _, ra = self._call(self._dense_owner(name),
                           {"cmd": "pull_dense", "name": name})
        return ra[0]

    def push_dense(self, name: str, grad: np.ndarray) -> None:
        self._call(self._dense_owner(name),
                   {"cmd": "push_dense", "name": name},
                   [np.asarray(grad, np.float32)])

    # ---- persistence / hygiene ----
    def save(self, table: str, path: str, mode: str = "base") -> list[str]:
        outs = self._all_with_shard_path(
            {"cmd": "save", "table": table, "mode": mode}, path)
        return [h["file"] for h, _ in outs]

    def load(self, table: str, path: str) -> None:
        self._all_with_shard_path({"cmd": "load", "table": table}, path)

    def _all_with_shard_path(self, header: dict, path: str):
        outs = [None] * self.n_servers

        def one(i):
            h = dict(header)
            h["path"] = f"{path}/shard-{i:03d}"
            outs[i] = self._call(i, h)
        self._fanout([lambda i=i: one(i) for i in range(self.n_servers)])
        return outs

    def shrink(self, table: str, min_show: float, decay: float = 1.0) -> int:
        outs = self._all({"cmd": "shrink", "table": table,
                          "min_show": min_show, "decay": decay})
        return sum(h["evicted"] for h, _ in outs)

    def stats(self) -> list[dict]:
        return [h for h, _ in self._all({"cmd": "stats"})]

    def stop_servers(self) -> list[str]:
        """Stop every server (each stops its dense tables' updaters) and
        return the endpoints that were already gone: a server that is
        gone is what stopping asks for; any other failure raises."""
        gone = []
        for i in range(self.n_servers):
            with self._locks[i]:
                try:
                    s = self._sock(i)
                    s.sendall(_pack({"cmd": "stop"}))
                    _recv_msg(s)
                except (ConnectionRefusedError, ConnectionResetError,
                        BrokenPipeError):
                    gone.append("%s:%d" % self.endpoints[i])
        self.close()
        return gone

    def close(self) -> None:
        for i in range(self.n_servers):
            self._drop(i)


# ---------------------------------------------------------------------------
# the store adapter: a Trainer on a PS cluster
# ---------------------------------------------------------------------------

class RemoteEmbeddingStore:
    """The ``HostEmbeddingStore`` pass API backed by a PS cluster, so the
    feed manager builds each pass's working set from the servers and the
    card-side pull/push path stays the same (the DownpourWorker regime).
    """

    # the table is SHARED between trainers: resident reuse and lazy
    # write-back would hide the other trainers' pushes, so the feed
    # manager rebuilds from the servers every pass and writes back
    # eagerly
    supports_resident_reuse = False

    def __init__(self, client: PSClient, table: str, cfg: EmbeddingConfig):
        self.client = client
        self.table = table
        self.cfg = cfg
        client.create_sparse_table(table, cfg)
        self._flush_hooks: list = []
        self._mutations = 0
        # set by an open BoxPS pass, as on a host store
        self.boundary_owner = None

    @property
    def mutation_count(self) -> int:
        return self._mutations

    def register_flush_hook(self, fn) -> None:
        self._flush_hooks.append(fn)

    def unregister_flush_hook(self, fn) -> None:
        if fn in self._flush_hooks:
            self._flush_hooks.remove(fn)

    def _run_flush_hooks(self) -> None:
        for fn in list(self._flush_hooks):
            fn()

    def __len__(self) -> int:
        return int(sum(s["sparse"].get(self.table, 0)
                       for s in self.client.stats()))

    def lookup_or_init(self, keys: np.ndarray) -> np.ndarray:
        return self.client.pull_sparse(self.table, keys, init_missing=True,
                                       rows=True)

    def peek_rows(self, keys: np.ndarray) -> np.ndarray:
        return self.client.pull_sparse(self.table, keys, init_missing=False,
                                       rows=True)

    def write_back(self, keys: np.ndarray, rows: np.ndarray) -> None:
        self.client.write_rows(self.table, keys, rows)

    def save_base(self, path: str) -> list[str]:
        self._run_flush_hooks()
        return self.client.save(self.table, path, mode="base")

    def save_delta(self, path: str) -> list[str]:
        self._run_flush_hooks()
        return self.client.save(self.table, path, mode="delta")

    def load(self, path: str) -> None:
        """Every server reloads its shard of ``path`` (a ``save_base``
        directory); the rows change under any reader, so this counts as a
        mutation."""
        self._run_flush_hooks()
        self._mutations += 1
        self.client.load(self.table, path)

    def shrink(self, min_show: float, decay: float = 1.0) -> int:
        self._run_flush_hooks()
        self._mutations += 1
        return self.client.shrink(self.table, min_show, decay)


def _main(argv: list[str] | None = None) -> None:
    """One standalone server process (the pserver role of fleetrun)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="python -m paddlebox_tpu_torch.distributed.ps --port N")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9000,
                    help="0 binds a free port (printed)")
    args = ap.parse_args(argv)
    srv = PSServer(args.host, args.port)
    print(f"ps server listening on {srv.host}:{srv.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    _main()
