"""Telemetry sinks — where hub events land; the port's copy of
``paddlebox_tpu/monitor/sinks.py``.

Mirrors the reference's three observability outputs: the dump channel's
background writer threads (→ :class:`JsonlSink`), the per-card
``log_for_profile`` stdout lines (→ :class:`ParityLogSink`), and the
in-memory ``StatRegistry`` readers (→ :class:`MemorySink`, used by tests
and the bench's artifact embed). Prometheus-style text exposition lives on
the hub itself (:meth:`TelemetryHub.prometheus_text`) since it reads the
counter registry, not the event stream.

Sink contract: ``emit(record)`` must be cheap and MUST NOT block the
training thread — the JSONL sink therefore writes from its own thread
behind a bounded queue and *drops* (counting drops) rather than ever
blocking; a sink that raises is error-isolated by the hub (disabled after
repeated failures) so a full disk or a closed pipe can never kill a
training run.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import sys
import threading
import time


class Sink:
    """Interface. ``emit`` receives one event dict (already tagged with
    pass/step/phase/thread by the hub)."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Bounded in-memory ring of events — tests and artifact embeds."""

    def __init__(self, cap: int = 4096):
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self.dropped = 0

    def emit(self, record: dict) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(record)

    @property
    def records(self) -> list[dict]:
        return list(self._ring)

    def find(self, name: str) -> list[dict]:
        return [r for r in self._ring if r.get("name") == name]


def segment_path(path: str, n: int) -> str:
    """Path of rotation segment ``n`` of a JSONL stream: segment 0 is
    ``path`` itself, segment k>0 inserts a zero-padded ordinal before the
    extension (``events.jsonl`` -> ``events.00001.jsonl``) so a plain
    lexical sort of the numbered siblings is chronological."""
    if n == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.{n:05d}{ext}"


class JsonlSink(Sink):
    """Background-thread JSONL event stream (the dump-channel shape,
    boxps_trainer.cc:96-108: producers enqueue, one writer thread owns the
    file handle and the serialization cost).

    Never blocks or raises into the emitting thread: a full queue drops
    the event (``dropped`` counts them — the stream says so on close via a
    final ``sink_dropped`` record), and a write failure latches ``error``
    while the drain keeps consuming so producers never wedge. The file is
    opened lazily on the writer thread, so a bad path is an ``error``, not
    an exception at construction.

    Rotation (``flags.telemetry_rotate_mb`` or the ``rotate_mb`` arg):
    when the current segment exceeds the budget the writer closes it —
    after a ``sink_rotated`` meta line naming the successor — and opens
    the next numbered segment (:func:`segment_path`). Every segment is
    whole lines only, so each stays independently schema-clean, and
    ``monitor/aggregate.py`` (either package's) stitches them back in
    order. A failed
    rotation latches ``error`` like any other write failure (behind the
    ``telemetry.rotate.pre`` faultpoint): telemetry stops, training does
    not."""

    def __init__(self, path: str, queue_size: int | None = None,
                 rotate_mb: int | None = None):
        from paddlebox_tpu_torch.config import flags
        if queue_size is None:
            queue_size = flags.telemetry_queue_size
        if rotate_mb is None:
            rotate_mb = flags.telemetry_rotate_mb
        self.path = path
        # the flag is whole MB; the constructor arg accepts fractions so
        # tests can exercise rotation without megabyte fixtures
        self.rotate_bytes = (int(float(rotate_mb) * (1 << 20))
                             if rotate_mb else 0)
        self.segments: list[str] = [path]   # written, in order
        self.dropped = 0
        self.written = 0
        self.rotations = 0
        self.error: BaseException | None = None
        self._q: queue.Queue = queue.Queue(maxsize=max(16, queue_size))
        # context.spawn, not a bare Thread: records emitted by the drain
        # itself (the sink_dropped meta line) stay pass-tagged like every
        # other event this file writes
        from paddlebox_tpu_torch.monitor.context import spawn
        self._thread = spawn(self._drain, name="pbtpu-telemetry-jsonl")
        self._thread.start()

    def emit(self, record: dict) -> None:
        try:
            self._q.put_nowait(record)
        except queue.Full:
            self.dropped += 1

    def _meta(self, name: str, **fields) -> str:
        return json.dumps({
            "ts": time.time(), "type": "meta", "name": name,
            "pass_id": None, "step": None, "phase": None,
            "thread": threading.current_thread().name,
            "fields": fields}) + "\n"

    def _rotate(self, f, seg_bytes: int):
        """Close the full segment and open the successor (writer thread
        only — it owns the handle). The old segment ends with a meta line
        naming the next segment so a reader can assert continuity."""
        from paddlebox_tpu_torch.utils import faultpoint
        faultpoint.hit("telemetry.rotate.pre")
        nxt = segment_path(self.path, len(self.segments))
        f.write(self._meta("sink_rotated", next=os.path.basename(nxt),
                           segment_bytes=seg_bytes))
        f.flush()
        f.close()
        f = open(nxt, "a")
        self.segments.append(nxt)
        self.rotations += 1
        return f

    def _drain(self) -> None:
        f = None
        seg_bytes = 0
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            f = open(self.path, "a")
            seg_bytes = f.tell()
        except BaseException as e:
            self.error = e
        while True:
            job = self._q.get()
            if job is None:
                break
            if self.error is not None:
                continue              # keep consuming; producers never block
            try:
                line = json.dumps(job, default=str) + "\n"
                f.write(line)
                self.written += 1
                seg_bytes += len(line)
                if self.rotate_bytes and seg_bytes >= self.rotate_bytes:
                    f = self._rotate(f, seg_bytes)
                    seg_bytes = 0
            except BaseException as e:
                self.error = e
        if f is not None and self.error is None:
            try:
                if self.dropped:
                    f.write(self._meta("sink_dropped",
                                       dropped=self.dropped))
                f.flush()
            except BaseException as e:
                self.error = e
        if f is not None:
            try:
                f.close()
            # pblint: disable=silent-except -- sink teardown: any write
            # failure was already latched in self.error above, and the
            # telemetry writer must never raise into its owner
            except OSError:
                pass

    def flush(self) -> None:
        # drain-to-empty best effort (bounded: the writer may be dead)
        deadline = time.time() + 2.0
        while not self._q.empty() and time.time() < deadline \
                and self._thread.is_alive():
            time.sleep(0.01)

    def close(self) -> None:
        """Stop the writer and close the file. Unlike DumpStream, a write
        error does NOT raise here — telemetry must never take down the
        training job it observes; inspect ``.error`` instead."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=10.0)


class ParityLogSink(Sink):
    """One ``log_for_profile``-parity line per flight record
    (boxps_worker.cc:746-759 prints the per-card read/trans/cal/sync split
    at pass end; this prints our stage split + throughput the same way).
    Ignores everything but flight records."""

    def __init__(self, stream=None):
        self._stream = stream

    def emit(self, record: dict) -> None:
        if record.get("type") != "flight_record":
            return
        stages = record.get("stage_seconds") or {}
        stage_txt = " ".join(f"{k}={stages[k]:.3f}s" for k in stages)
        line = (f"[pbtpu] pass={record.get('pass_id')} "
                f"phase={record.get('phase')} "
                f"steps={record.get('steps')} "
                f"examples={record.get('examples')} "
                f"eps={record.get('examples_per_sec', 0.0):.1f} "
                f"{stage_txt} "
                f"total={record.get('seconds', 0.0):.3f}s")
        print(line, file=self._stream or sys.stdout, flush=True)
