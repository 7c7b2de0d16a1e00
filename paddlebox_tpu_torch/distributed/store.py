"""Filesystem rendezvous KV store.

Reference: gloo's ``HdfsStore`` (gloo_wrapper.h:45) — set/get/wait on a
shared filesystem so hosts can rendezvous without a standing service. Works
on any mount every host can see (NFS, FUSE'd object store, /tmp for
single-machine tests).

Crash-resilience notes (multi-host recovery protocol):

- ``set`` publishes atomically through a tmp file whose suffix carries
  hostname + pid + a fresh uuid — two HOSTS on a shared mount can share a
  pid, so a pid-only suffix could interleave two writers' bytes into one
  tmp file and publish garbage.
- ``namespace`` (normally the per-launch run id) prefixes every key, so a
  relaunched job against the same persistent store dir can never read —
  or be satisfied by — a previous launch's keys. :meth:`sweep_stale`
  additionally reclaims abandoned keys by age (disk hygiene; the
  namespace is the correctness barrier, age-based cleanup is not).
- ``wait``/``wait_count`` accept a ``check`` callable polled every loop
  iteration: the heartbeat watchdog raises through it with *named* dead or
  stalled ranks instead of letting the caller sit out an opaque timeout,
  and ``wait_count``'s own timeout names which ranks never arrived.
"""

from __future__ import annotations

import os
import re
import socket
import time
import uuid
from typing import Callable


class FileStore:
    def __init__(self, root: str, timeout_s: float = 300.0,
                 poll_s: float = 0.02, namespace: str = ""):
        self.root = root
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        # key namespace (the launcher's run id): "" = no prefix, matching
        # the single-host/test default
        self.namespace = namespace
        os.makedirs(root, exist_ok=True)

    def scoped(self, suffix: str) -> "FileStore":
        """A view of the same store dir with ``suffix`` appended to the
        namespace. The elastic world re-formation protocol scopes every
        generation's keys this way (``run_id.gN``): a rank still at
        generation N-1 can never satisfy — or be satisfied by — a
        generation-N wait, so a shrunk world and a fenced straggler can
        share the store dir without mixing."""
        ns = f"{self.namespace}.{suffix}" if self.namespace else suffix
        return FileStore(self.root, timeout_s=self.timeout_s,
                         poll_s=self.poll_s, namespace=ns)

    def _path(self, key: str) -> str:
        if self.namespace:
            key = f"{self.namespace}.{key}"
        safe = key.replace("/", "_")
        return os.path.join(self.root, safe)

    def set(self, key: str, value: bytes) -> None:
        path = self._path(key)
        # hostname + pid + uuid: pid alone collides across hosts sharing
        # the mount, and a recycled pid on one host could race its
        # predecessor's leftover tmp file
        tmp = (f"{path}.tmp.{socket.gethostname()}.{os.getpid()}."
               f"{uuid.uuid4().hex[:8]}")
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, path)  # atomic publish

    def set_exclusive(self, key: str, value: bytes) -> bool:
        """Publish ``key`` only if it does not exist yet; returns whether
        THIS caller won. Atomic via ``os.link`` (hard-link creation fails
        with EEXIST exactly once per target, and the linked content is
        complete — the classic NFS-safe lockfile move), so N racing
        writers agree on a single winner whose full value every reader
        sees. The elastic re-formation protocol seals each generation's
        membership through this: one survivor's proposal becomes THE
        membership record for that generation."""
        path = self._path(key)
        tmp = (f"{path}.tmp.{socket.gethostname()}.{os.getpid()}."
               f"{uuid.uuid4().hex[:8]}")
        with open(tmp, "wb") as f:
            f.write(value)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            os.remove(tmp)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        # pblint: disable=silent-except -- delete is idempotent by
        # contract: absent already means deleted
        except FileNotFoundError:
            pass

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def wait(self, key: str, timeout_s: float | None = None,
             check: Callable[[], None] | None = None) -> bytes:
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        while True:
            v = self.get(key)
            if v is not None:
                return v
            if check is not None:
                check()          # watchdog: raise with named ranks
            if time.monotonic() > deadline:
                raise TimeoutError(f"store key {key!r} not set within "
                                   f"{timeout_s or self.timeout_s}s")
            time.sleep(self.poll_s)

    def add(self, key: str, rank: int) -> None:
        """Register `rank` under a multi-writer key (barrier membership)."""
        self.set(f"{key}.{rank}", b"1")

    def count(self, key: str, world: int) -> int:
        return world - len(self.missing_ranks(key, world))

    def missing_ranks(self, key: str, world: int) -> list[int]:
        return [r for r in range(world)
                if not os.path.exists(self._path(f"{key}.{r}"))]

    def wait_count(self, key: str, world: int,
                   timeout_s: float | None = None,
                   check: Callable[[], None] | None = None) -> None:
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        while True:
            missing = self.missing_ranks(key, world)
            if not missing:
                return
            if check is not None:
                check()          # watchdog: raise with named ranks
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"barrier {key!r}: {world - len(missing)}/{world} "
                    f"ranks arrived; missing ranks {missing}")
            time.sleep(self.poll_s)

    def keys(self, prefix: str = "") -> list[str]:
        """Published keys in THIS namespace starting with ``prefix``,
        sorted. In-flight ``.tmp.`` files are skipped (they are not yet
        published), and other namespaces' keys are invisible — same
        isolation as every read path. Keys are returned in their stored
        (sanitized) form: ``/`` became ``_`` at publish time. The elastic
        grow protocol discovers pending admit registrations this way."""
        own = f"{self.namespace}." if self.namespace else ""
        want = own + prefix.replace("/", "_")
        out = []
        for name in os.listdir(self.root):
            if ".tmp." in name:
                continue
            if name.startswith(want):
                out.append(name[len(own):])
        return sorted(out)

    def sweep_stale(self, max_age_s: float | None = None,
                    rank: int | None = None) -> int:
        """Store hygiene; returns the count of files removed. Two modes,
        combinable:

        - ``max_age_s``: unlink OTHER namespaces' store files older than
          ``max_age_s`` (by mtime). For persistent store dirs reused
          across launches — an abandoned run's keys (and orphaned
          ``.tmp.`` files) would otherwise accumulate forever. The run-id
          *namespace* is what prevents a previous launch's keys from
          satisfying a barrier; this sweep merely reclaims the disk.
          The current namespace's keys are NEVER age-swept, whatever
          their age: a rank can legitimately sit minutes in a barrier (a
          straggler peer in a long pass) with its arrival file aging past
          any threshold — deleting it would wedge the live collective.

        - ``rank``: remove the named DEPARTED rank's keys *within the
          live namespace* — its heartbeat (``hb.<rank>``), barrier
          arrivals and collective contributions (keys whose final dot
          component is ``<rank>`` or ``v<rank>``). After an elastic world
          shrink the new generation's ``wait_count`` must never count the
          ghost's stale arrivals, and a lingering heartbeat file would
          read as a live-then-frozen peer forever. Rank ownership is
          encoded in the key suffix by every writer (``add``, the
          collectives, the heartbeat monitor, the re-formation protocol);
          non-rank-owned keys (sealed ``...gN`` records, ``.out`` reduce
          results) never end in a bare rank number. Generation-scoped
          sub-namespaces (``<ns>.gN.…``) are NEVER rank-swept: their
          keys use the generation's DENSE renumbering, so an original
          rank id could alias a surviving rank's live key there (old
          generations are inert and age out; the new one is live).

        An un-namespaced store refuses to sweep (no way to tell our keys
        from a dead run's, nor a rank's keys from same-named files of
        another launch). Concurrent-safe: a racing unlink is ignored."""
        if not self.namespace:
            raise ValueError(
                "sweep_stale needs a namespaced store: without a run-id "
                "prefix the sweep cannot distinguish the live run's keys "
                "(e.g. a barrier arrival aging while a straggler trains) "
                "from an abandoned run's")
        if max_age_s is None and rank is None:
            raise ValueError("sweep_stale needs max_age_s and/or rank")
        own = f"{self.namespace}."
        rank_suffixes = (None if rank is None
                         else {str(int(rank)), f"v{int(rank)}"})
        now = time.time()
        removed = 0
        for name in os.listdir(self.root):
            p = os.path.join(self.root, name)
            try:
                if name.startswith(own):
                    # live namespace: only the departed rank's keys go —
                    # but never inside a generation scope, whose dense
                    # renumbering could alias a survivor's key
                    rest = name[len(own):]
                    gen_scoped = re.match(r"g\d+\.", rest) is not None
                    if (rank_suffixes is not None and not gen_scoped
                            and ".tmp." not in name
                            and name.rsplit(".", 1)[-1] in rank_suffixes):
                        os.remove(p)
                        removed += 1
                    continue
                if (max_age_s is not None
                        and now - os.path.getmtime(p) > max_age_s):
                    os.remove(p)
                    removed += 1
            # pblint: disable=silent-except -- raced with another sweeper
            # or a live writer; the other party owns the outcome
            except OSError:
                pass
        return removed
