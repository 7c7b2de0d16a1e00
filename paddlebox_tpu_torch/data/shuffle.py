"""The cross-host global shuffle — the port of ``data/shuffle.py``.

Every host routes each record to a destination host by a routing key
(``route_records``: ``random`` from the persistent shuffle generator,
the splitmix64 hash of ``ins_id``, or ``search_id`` modulo the world,
the reference's data_set.cc:1934-1942 switch, as in the JAX package),
serializes each destination's sub-batch and sends it over TCP
(``TcpShuffleService``); receivers concatenate what arrived. The shuffle
is host work: nothing here touches the card.

The wire is the JAX package's: per message an 8-byte big-endian length
and an ``np.savez`` payload (``serialize_batch`` / ``deserialize_batch``
read each other's bytes both ways); a zero length ends a peer's stream.
Two keys ride beside the batch's arrays, ``src`` (the sender's rank) and
``round`` (the sender's exchange count), and every peer gets one payload
a round, an empty batch when nothing routes to it. The JAX service
counts connections instead, so at world >= 3 a fast rank's next round
can be taken for a slow peer's current one, and it keeps the sub-batches
in arrival order; the port's receiver files each payload under its
(round, src) and returns a round's batches in rank order, so the
concatenation (and the permutation drawn over it next) is the same on
every run.

``elastic_reroute`` re-partitions a departed rank's unconsumed records
over the survivors from the persistent generator: every survivor holds
the same generator state, computes the same destinations and keeps its
own share, with no exchange (``distributed/resilience.py``).
"""

from __future__ import annotations

import io
import socket
import struct
import threading
import time
from typing import Literal, Sequence

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor import counter_add
from paddlebox_tpu_torch.utils.hashing import hash64_array

RoutingMode = Literal["random", "ins_id", "search_id"]


def route_records(batch: SlotRecordBatch, world_size: int, mode: RoutingMode,
                  seed: int = 0, rng: np.random.Generator | None = None
                  ) -> list[SlotRecordBatch | None]:
    """Split a batch into per-destination sub-batches (None where no
    record routes). ``random`` draws from ``rng`` when given (the
    persistent, checkpointable generator, so a resumed rank replays the
    same routing) and from a throwaway generator seeded with ``seed``
    otherwise. A world of one routes without drawing."""
    if world_size == 1:
        return [batch]
    if mode == "search_id":
        dest = (batch.search_id % np.uint64(world_size)).astype(np.int64)
    elif mode == "ins_id":
        dest = (hash64_array(batch.ins_id)
                % np.uint64(world_size)).astype(np.int64)
    elif mode == "random":
        rng = np.random.default_rng(seed) if rng is None else rng
        dest = rng.integers(0, world_size, size=batch.num)
    else:
        raise ValueError(f"routing mode {mode!r}; expected "
                         "random|ins_id|search_id")
    out: list[SlotRecordBatch | None] = []
    for r in range(world_size):
        idx = np.nonzero(dest == r)[0]
        out.append(batch.select(idx) if len(idx) else None)
    return out


# ---- serialization (the reference's BinaryArchive, data_feed.h:1536) ----

def serialize_batch(batch: SlotRecordBatch, **extra: np.ndarray) -> bytes:
    """The batch as ``np.savez`` bytes under the JAX package's keys;
    ``extra`` adds arrays under other keys (a reader that does not know
    them skips them)."""
    buf = io.BytesIO()
    arrays: dict[str, np.ndarray] = {
        "ins_id": batch.ins_id, "search_id": batch.search_id,
        "rank": batch.rank, "cmatch": batch.cmatch,
        "num": np.asarray([batch.num], dtype=np.int64),
    }
    for i, (v, o) in enumerate(zip(batch.sparse_values,
                                   batch.sparse_offsets)):
        arrays[f"sv{i}"] = v
        arrays[f"so{i}"] = o
    for i, fv in enumerate(batch.float_values):
        arrays[f"fv{i}"] = fv
    arrays.update(extra)
    np.savez(buf, **arrays)
    return buf.getvalue()


def deserialize_batch(data: bytes, schema) -> SlotRecordBatch:
    return _deserialize(data, schema)[0]


def _deserialize(data: bytes, schema) -> tuple[SlotRecordBatch, dict]:
    """The batch and the extra keys' arrays of one payload."""
    with np.load(io.BytesIO(data)) as z:
        n_sparse = len(schema.sparse_slots)
        n_float = len(schema.float_slots)
        batch = SlotRecordBatch(
            schema=schema, num=int(z["num"][0]),
            sparse_values=[z[f"sv{i}"] for i in range(n_sparse)],
            sparse_offsets=[z[f"so{i}"] for i in range(n_sparse)],
            float_values=[z[f"fv{i}"] for i in range(n_float)],
            ins_id=z["ins_id"], search_id=z["search_id"],
            rank=z["rank"], cmatch=z["cmatch"])
        extra = {k: z[k] for k in ("src", "round") if k in z.files}
    return batch, extra


def elastic_reroute(batch: SlotRecordBatch, world_size: int,
                    rng: np.random.Generator
                    ) -> list[SlotRecordBatch | None]:
    """Re-partition a departed rank's unconsumed records across the
    surviving world: ``route_records`` in random mode from the persistent
    generator. Survivors holding the same generator state and calling
    this with the same inputs in the same order compute the same
    destinations, so each record lands on exactly one survivor with no
    traffic, and the generator advances alike everywhere (an empty batch
    draws nothing; a world of one draws nothing)."""
    return route_records(batch, world_size, "random", rng=rng)


class LocalShuffler:
    """Single-host shuffle: a permutation from a persistent generator.
    ``state_dict`` / ``load_state_dict`` round-trip the bit-generator
    state (JSON-serializable, the same dict in both packages), which a
    pass snapshot records as the dataset's shuffle cursor."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def shuffle(self, batch: SlotRecordBatch) -> SlotRecordBatch:
        return batch.shuffle(self.rng)

    def state_dict(self) -> dict:
        return self.rng.bit_generator.state

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state


class TcpShuffleService:
    """Peer-to-peer record exchange over TCP, one instance per host,
    bound to ``endpoints[rank]`` when built (so peers may connect before
    this rank's first ``exchange``).

    ``exchange`` sends this host's routed sub-batches to every peer (a
    refused connection retries until the deadline: a peer may not have
    bound yet) while a listener thread, alive from construction to
    ``close``, files what peers send. It returns this round's batches
    from every rank, its own included, in rank order. Fail-stop: a peer
    whose payload has not arrived by the deadline means records are
    missing, and training on the rest would be training on truncated
    data, so ``exchange`` raises."""

    def __init__(self, rank: int, endpoints: Sequence[str],
                 timeout_s: float = 120.0):
        self.rank = int(rank)
        self.endpoints = list(endpoints)
        self.world = len(self.endpoints)
        self.timeout_s = float(timeout_s)
        self._round = 0
        # (round, src) -> (batch, payload bytes), filed by the listener
        self._inbox: dict[tuple[int, int],
                          tuple[SlotRecordBatch, int]] = {}
        self._schema = None
        self._cv = threading.Condition()
        self._listen_error: BaseException | None = None
        self._stop = threading.Event()
        self.last_exchange: dict = {}
        host, port = self.endpoints[self.rank].rsplit(":", 1)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(max(1, self.world))
        # accept() wakes up to see close()
        self._srv.settimeout(0.2)
        self._thread = mon_ctx.spawn(self._listen,
                                     name=f"pbt-shuffle-{self.rank}")
        self._thread.start()

    # -- receiving ---------------------------------------------------------

    def _listen(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError as e:
                if not self._stop.is_set():
                    self._fail(e)
                return
            try:
                with conn:
                    conn.settimeout(self.timeout_s)
                    self._read_stream(conn)
            except (OSError, ValueError, KeyError) as e:
                self._fail(e)
                return

    def _read_stream(self, conn: socket.socket) -> None:
        while True:
            (ln,) = struct.unpack(">Q", _recv_exact(conn, 8))
            if ln == 0:
                return
            payload = _recv_exact(conn, ln)
            with self._cv:
                while self._schema is None and not self._stop.is_set():
                    # a fast peer's payload before this rank's first
                    # exchange: the schema arrives with it
                    self._cv.wait(0.2)
                schema = self._schema
            if schema is None:
                return
            batch, extra = _deserialize(payload, schema)
            if "src" not in extra or "round" not in extra:
                raise ValueError("shuffle payload without its src/round "
                                 "keys (not a port peer)")
            key = (int(extra["round"][0]), int(extra["src"][0]))
            with self._cv:
                self._inbox[key] = (batch, len(payload))
                self._cv.notify_all()

    def _fail(self, e: BaseException) -> None:
        with self._cv:
            self._listen_error = e
            self._cv.notify_all()

    # -- the exchange ------------------------------------------------------

    def exchange(self, outgoing: list[SlotRecordBatch | None],
                 schema) -> list[SlotRecordBatch]:
        """Send ``outgoing[peer]`` to every peer and collect this round's
        batches from all ranks (empty ones dropped), in rank order.
        Raises RuntimeError when a peer's payload is missing at the
        service's deadline (``timeout_s``)."""
        if len(outgoing) != self.world:
            raise ValueError(f"{len(outgoing)} sub-batches for a world of "
                             f"{self.world}")
        t0 = time.perf_counter()
        deadline = time.monotonic() + self.timeout_s
        rnd = self._round
        self._round += 1
        with self._cv:
            self._schema = schema
            self._cv.notify_all()
        empty = SlotRecordBatch.empty(schema)
        sent = 0
        for peer in range(self.world):
            if peer == self.rank:
                continue
            sub = outgoing[peer]
            payload = serialize_batch(
                sub if sub is not None else empty,
                src=np.asarray([self.rank], np.int64),
                round=np.asarray([rnd], np.int64))
            self._send(peer, payload, deadline)
            sent += len(payload)
        peers = [p for p in range(self.world) if p != self.rank]
        with self._cv:
            while True:
                if self._listen_error is not None:
                    raise RuntimeError(
                        f"global shuffle exchange failed: "
                        f"{self._listen_error!r}") from self._listen_error
                missing = [p for p in peers
                           if (rnd, p) not in self._inbox]
                if not missing:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    # a slow or dead peer past the deadline means records
                    # are missing: fail-stop (data_set.cc:1393-1417)
                    raise RuntimeError(
                        f"global shuffle exchange timed out after "
                        f"{self.timeout_s:.0f}s: received from "
                        f"{len(peers) - len(missing)}/{len(peers)} peers "
                        f"(missing ranks {missing})")
                self._cv.wait(min(left, 0.2))
            got = {p: self._inbox.pop((rnd, p)) for p in peers}
        recv_bytes = sum(n for _, n in got.values())
        batches = {p: b for p, (b, _) in got.items()}
        mine = outgoing[self.rank]
        if mine is not None:
            batches[self.rank] = mine
        received = [batches[r] for r in sorted(batches)
                    if batches[r].num > 0]
        self.last_exchange = {
            "round": rnd, "sent_bytes": sent, "received_bytes": recv_bytes,
            "received_records": int(sum(b.num for b in received)),
            "seconds": time.perf_counter() - t0}
        counter_add("shuffle.sent_bytes", sent)
        counter_add("shuffle.received_bytes", recv_bytes)
        return received

    def _send(self, peer: int, payload: bytes, deadline: float) -> None:
        host, port = self.endpoints[peer].rsplit(":", 1)
        while True:
            try:
                with socket.create_connection(
                        (host, int(port)),
                        timeout=max(1.0, deadline - time.monotonic())) as s:
                    s.sendall(struct.pack(">Q", len(payload)) + payload)
                    s.sendall(struct.pack(">Q", 0))
                return
            except ConnectionRefusedError:
                # the peer has not bound its endpoint yet
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"global shuffle: peer {peer} at "
                        f"{self.endpoints[peer]} refused connections "
                        f"until the deadline") from None
                time.sleep(0.05)

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._srv.close()
        self._thread.join(timeout=5.0)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        c = conn.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed mid-message")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)
