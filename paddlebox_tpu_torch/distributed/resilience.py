"""Whole-world crash resilience — the port of ``distributed/
resilience.py``: the heartbeat watchdog, the coordinated resume election
and the elastic world.

- :class:`HeartbeatMonitor` — every rank publishes a run-scoped heartbeat
  key (a sequence number plus the live pass/step, read from
  ``monitor.context``, so no trainer wiring is needed) and watches its
  peers: a sequence that stops advancing means the process is gone
  (``peer_lost``); one that advances while pass/step progress is frozen
  means the rank is hung (``peer_stalled``). Both emit telemetry and
  raise :class:`PeerLostError` / :class:`PeerStalledError` naming the
  ranks through the ``check`` hook every ``FileStore`` wait polls, so a
  dead peer fails a barrier by name instead of by the store's timeout.
  Each heartbeat echoes the peers' last stamps, and a closed round trip
  becomes a ``trace.clock_probe`` event (``monitor.trace.ntp_offset``).
  The publisher records its own beat gaps (``jitter``): it shares the
  GIL with the pack thread, the push stager and the telemetry writer.
- :func:`coordinated_resume` — every rank publishes its intact snapshot
  cursors, the world elects the highest cursor every rank holds intact
  (:func:`elect_resume_cursor`), barriers, restores exactly that snapshot
  everywhere and barriers again; when any rank holds nothing, the whole
  world starts fresh and every rank discards its snapshots.
- :class:`ElasticWorld` — instead of fail-stopping on a named peer
  failure, the survivors re-form at N-1 through a generation-sealed
  protocol over the rendezvous store: arrivals under generation g, one
  exclusive-create seal (that record IS the membership; a rank not named
  in it is fenced), acks, and escalation to g+1 past a member that dies
  inside the protocol. Every formed generation's keys live in their own
  store scope (``gN``), and the departed ranks' keys are swept.
  ``admit`` is the grow side: a replacement registers and joins the next
  generation the incumbents seal with it.

The world here is the host control plane only (``FileStore`` /
``HostCollectives``). A ``torch.distributed`` process group is never
re-formed: as in the JAX package, whose elastic workers each train on a
one-device mesh, an elastic rank trains on its own card (no ``mesh``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags as config_flags
from paddlebox_tpu_torch.distributed.collectives import HostCollectives
from paddlebox_tpu_torch.distributed.store import FileStore
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor.trace import ntp_offset
from paddlebox_tpu_torch.utils import faultpoint


class PeerFailureError(RuntimeError):
    """A peer rank is dead or hung; carries the offending ranks."""

    def __init__(self, msg: str, ranks: list[int]):
        super().__init__(msg)
        self.ranks = list(ranks)


class PeerLostError(PeerFailureError):
    """Peer heartbeat stopped entirely — the process is gone."""


class PeerStalledError(PeerFailureError):
    """Peer heartbeat still beats but its pass/step progress is frozen —
    the rank is hung (stuck collective, deadlocked IO, live-lock)."""


# the publisher's beat-gap record: the newest this many gaps
_GAP_WINDOW = 4096


class HeartbeatMonitor:
    """Publish this rank's heartbeat and watch every peer's.

    The payload is JSON ``{seq, rank, pid, host, pass, step, ts, echo}``.
    ``seq`` increments per publish; staleness is judged by observed change
    against the local monotonic clock, never by comparing wall clocks
    across hosts (a shared-filesystem store gives no clock guarantee).

    - lost: a peer's ``seq`` has not advanced for ``lost_after_s``. The
      publisher is a daemon thread that outlives any Python-level hang,
      so a frozen seq means the process is gone;
    - stalled: ``seq`` advances but ``(pass, step)`` has not changed for
      ``stall_after_s`` (only a rank that has published progress can
      stall; one idling before its first pass is merely slow).

    A watchdog thread scans the peers every ``interval_s`` and latches
    the first failure; :meth:`check` (polled inside every store wait via
    ``HostCollectives.watchdog``) re-raises it. Without the thread
    (``watch=False``) ``check`` scans inline. ``rank_names`` maps this
    monitor's dense ranks to the launcher's original ones (a shrunk
    world renumbers densely); errors and events name original ranks.
    """

    def __init__(self, store: FileStore, rank: int, world: int,
                 run_id: str = "", interval_s: float | None = None,
                 lost_after_s: float | None = None,
                 stall_after_s: float | None = None,
                 watch: bool = True, start: bool = True,
                 rank_names: list[int] | None = None):
        self.store = store
        self.rank = rank
        self.world = world
        self._names = (None if rank_names is None
                       else [int(r) for r in rank_names])
        prefix = f"{run_id}." if run_id else ""
        self._key = lambda r: f"{prefix}hb.{r}"
        self.interval_s = (config_flags.heartbeat_interval_s
                           if interval_s is None else float(interval_s))
        self.lost_after_s = (config_flags.heartbeat_lost_s
                             if lost_after_s is None else float(lost_after_s))
        self.stall_after_s = (config_flags.heartbeat_stall_s
                              if stall_after_s is None
                              else float(stall_after_s))
        self._seq = 0
        self._stop = threading.Event()
        self._failure: PeerFailureError | None = None
        self._reported: set[tuple[str, int]] = set()
        # per peer: [last_seq, seq_seen_mono, last_progress,
        #   progress_seen_mono, last_payload_ts, payload_read_wall]
        # (the last two feed the clock-probe echo)
        self._obs: dict[int, list] = {}
        # injectable wall clock (a test skews one monitor's wall);
        # liveness never reads it
        self._wall = time.time
        self._watch = watch
        self._threads: list[threading.Thread] = []
        # the publisher thread's gaps between consecutive beats (seconds)
        self._gaps: list[float] = []
        if start:
            self.start()

    def _name(self, r: int) -> int:
        return r if self._names is None else self._names[r]

    # -- publishing --------------------------------------------------------

    def publish(self) -> None:
        """Write one heartbeat for this rank (the publisher thread calls
        it every ``interval_s``; BoxPS at each pass boundary).

        The payload carries the publish wall clock (``ts``) and an
        ``echo`` of every peer observation this rank holds (``{peer:
        [peer_seq, peer_payload_ts, my_wall_at_read]}``): one heartbeat
        each way closes a round trip, which :meth:`scan` turns into a
        ``trace.clock_probe`` event. Liveness never compares these
        clocks."""
        self._seq += 1
        ctx = mon_ctx.current()
        now_wall = self._wall()
        echo = {}
        # a snapshot: the watchdog's scan() inserts new peers into _obs
        # concurrently, and iterating the live dict would kill this
        # thread (a self-inflicted peer_lost)
        for r, obs in list(self._obs.items()):
            if obs[0] is not None and obs[4] is not None:
                echo[str(r)] = [obs[0], obs[4], obs[5]]
        payload = {"seq": self._seq, "rank": self.rank, "pid": os.getpid(),
                   "host": socket.gethostname(),
                   "pass": ctx.pass_id, "step": ctx.step,
                   "ts": now_wall, "echo": echo}
        self.store.set(self._key(self.rank), json.dumps(payload).encode())

    def _publisher(self) -> None:
        last = None
        while not self._stop.is_set():
            now = time.monotonic()
            if last is not None:
                self._gaps.append(now - last)
                if len(self._gaps) > _GAP_WINDOW:
                    del self._gaps[:len(self._gaps) - _GAP_WINDOW]
            last = now
            try:
                self.publish()
            except OSError:
                # a store blip: a late beat beats a dead publisher; a
                # real outage shows as this rank's seq freezing on every
                # peer's watchdog
                monitor.counter_add("resilience.heartbeat_publish_errors")
            self._stop.wait(self.interval_s)

    def jitter(self) -> dict:
        """The publisher's beats so far: count, the configured interval,
        and the mean / p99 / max gap between consecutive beats (seconds).
        A gap far above the interval is a beat the GIL or the host held
        back."""
        gaps = sorted(self._gaps)
        if not gaps:
            return {"beats": 0, "interval_s": self.interval_s}
        return {"beats": len(gaps) + 1, "interval_s": self.interval_s,
                "mean_gap_s": sum(gaps) / len(gaps),
                "p99_gap_s": gaps[min(len(gaps) - 1,
                                      int(0.99 * len(gaps)))],
                "max_gap_s": gaps[-1]}

    def _watchdog(self) -> None:
        while not self._stop.is_set():
            try:
                self.scan()
            except PeerFailureError:
                return           # latched; check() raises it to the caller
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._threads:
            return
        t = mon_ctx.spawn(self._publisher,
                          name=f"pbt-heartbeat-{self.rank}")
        t.start()
        self._threads.append(t)
        if self._watch and self.world > 1:
            w = mon_ctx.spawn(self._watchdog,
                              name=f"pbt-watchdog-{self.rank}")
            w.start()
            self._threads.append(w)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.interval_s + 2.0)
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- watching ----------------------------------------------------------

    def _read_peer(self, r: int) -> dict | None:
        raw = self.store.get(self._key(r))
        if raw is None:
            return None
        try:
            return json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            return None          # a torn read under a non-atomic rename

    def scan(self) -> None:
        """One watchdog pass over every peer; latches and raises on the
        first dead or stalled peers found. A rank never seen at all is in
        a grace period (startup skew) judged against ``lost_after_s``
        from the first scan."""
        now = time.monotonic()
        lost, stalled = [], []
        for r in range(self.world):
            if r == self.rank:
                continue
            p = self._read_peer(r)
            obs = self._obs.get(r)
            if obs is None:
                obs = self._obs[r] = [None, now, None, now, None, None]
            if p is not None and p.get("seq") != obs[0]:
                obs[0], obs[1] = p.get("seq"), now
                # when (peer clock, ours) this fresh payload was read —
                # the echo we publish — and close the round trip the
                # peer's echo of us opens
                obs[4], obs[5] = p.get("ts"), self._wall()
                self._emit_clock_probe(r, p, obs[5])
            prog = None if p is None else (p.get("pass"), p.get("step"))
            if prog != obs[2]:
                obs[2], obs[3] = prog, now
            if now - obs[1] > self.lost_after_s:
                lost.append(r)
            elif (obs[0] is not None and prog is not None
                    and prog != (None, None)
                    and now - obs[3] > self.stall_after_s):
                stalled.append(r)
        for kind, ranks in (("peer_lost", lost), ("peer_stalled", stalled)):
            if not ranks:
                continue
            lost_kind = kind == "peer_lost"
            limit = self.lost_after_s if lost_kind else self.stall_after_s
            for r in ranks:
                if (kind, r) in self._reported:
                    continue
                self._reported.add((kind, r))
                fields = dict(rank=int(self._name(r)),
                              observer=int(self._name(self.rank)),
                              after_s=limit)
                if lost_kind:
                    monitor.counter_add("resilience.peer_lost")
                    monitor.event("peer_lost", **fields)
                else:
                    monitor.counter_add("resilience.peer_stalled")
                    monitor.event("peer_stalled", **fields)
            named = [self._name(r) for r in ranks]
            what = ("lost (heartbeat stopped)" if lost_kind
                    else "stalled (no pass/step progress)")
            exc = PeerLostError if lost_kind else PeerStalledError
            err = exc(f"rank{'s' if len(named) > 1 else ''} {named} "
                      f"{what} for > {limit:.1f}s (observer rank "
                      f"{self._name(self.rank)})", named)
            if self._failure is None:
                self._failure = err
            raise err

    def _emit_clock_probe(self, r: int, p: dict, t3: float) -> None:
        """One offset sample from a closed heartbeat round trip: our
        payload ts came back in the peer's echo (t0, our clock) with the
        peer's read time (t1) and publish time (t2, peer clock); ``t3``
        is our read of the echo."""
        try:
            mine = (p.get("echo") or {}).get(str(self.rank))
            t2 = p.get("ts")
            if not mine or t2 is None:
                return
            _seq0, t0, t1 = mine
            if t0 is None or t1 is None:
                return
            offset, rtt = ntp_offset(float(t0), float(t1), float(t2),
                                     float(t3))
            monitor.event("trace.clock_probe", peer=int(self._name(r)),
                          observer=int(self._name(self.rank)),
                          offset_s=round(offset, 6), rtt_s=round(rtt, 6))
        except (TypeError, ValueError, IndexError):
            # a malformed echo (a foreign or older payload) is not a
            # probe, and never a liveness verdict
            monitor.counter_add("trace.clock_probe_errors")

    def check(self) -> None:
        """Raise the latched (or freshly scanned) peer failure, if any.
        Cheap enough to poll from the store wait loops."""
        if self._failure is not None:
            raise self._failure
        if not self._watch or not self._threads:
            self.scan()


# ---------------------------------------------------------------------------
# the coordinated resume election
# ---------------------------------------------------------------------------

def elect_resume_cursor(local_cursors: list[tuple[int, int]],
                        all_cursors: list[list]) -> tuple[int, int] | None:
    """The pure election: the highest ``(pass_id, mid_steps)`` present in
    ALL the gathered intact-cursor lists, or None when no snapshot is
    common (a whole-world fresh start). Every rank computes the same
    result from the same gathered lists, so no leader is needed."""
    common = set(tuple(c) for c in all_cursors[0])
    for lst in all_cursors[1:]:
        common &= set(tuple(c) for c in lst)
    del local_cursors  # the same information rides all_cursors
    return max(common) if common else None


def coordinated_resume(checkpointer, trainer, collectives: HostCollectives,
                       box=None, metrics=None) -> dict | None:
    """Whole-world resume: elect the newest snapshot intact on EVERY rank,
    restore it everywhere, and barrier so no rank trains ahead.

    Returns the elected snapshot's cursor dict (plus ``"elected"``), or
    None when any rank has nothing intact: the world starts fresh
    together, and every rank discards its snapshots (a stale pass-N
    snapshot left on one rank could match a freshly retrained pass N on
    another at a later election)."""
    mine = checkpointer.intact_cursors()
    gathered = collectives.all_gather([list(c) for c in mine],
                                      name="resume_candidates")
    elected = elect_resume_cursor(mine, gathered)
    monitor.event("resume_election",
                  elected=(list(elected) if elected else None),
                  rank=collectives.rank,
                  local_newest=(list(mine[-1]) if mine else None),
                  world=collectives.world)
    # every rank has read the gathered lists before any rank's restore
    # starts rewriting or pruning snapshots
    collectives.barrier("resume_elected")
    if elected is None:
        checkpointer.discard_all_snapshots()
        collectives.barrier("resume_fresh")
        return None
    if elected not in mine:
        raise RuntimeError(
            f"rank {collectives.rank} elected cursor {elected} is not in "
            f"its intact set {mine} — election protocol violated")
    cursor = checkpointer.resume(trainer, box=box, metrics=metrics,
                                 at=elected)
    monitor.counter_add("resilience.coordinated_resumes")
    # no rank enters the pass loop until the whole world stands on the
    # elected snapshot
    collectives.barrier("resume_restored")
    cursor["elected"] = list(elected)
    return cursor


# ---------------------------------------------------------------------------
# the elastic world (shrink to N-1 and continue; admit to grow)
# ---------------------------------------------------------------------------


class WorldFencedError(RuntimeError):
    """This rank was excluded from a sealed generation: the surviving
    world moved on without it. Its state belongs to a timeline the world
    abandoned; the only safe response is a clean exit."""

    def __init__(self, gen: int, members: list[int], rank: int):
        super().__init__(
            f"rank {rank} fenced: generation {gen} sealed with members "
            f"{members} — this rank is no longer part of the world")
        self.gen = gen
        self.members = list(members)


class WorldTooSmallError(RuntimeError):
    """Surviving membership fell below ``flags.elastic_min_world``: the
    training loop should checkpoint and exit cleanly instead of
    continuing."""

    def __init__(self, survivors: list[int], floor: int):
        super().__init__(
            f"survivors {survivors} fall below elastic_min_world={floor}; "
            f"checkpoint and exit cleanly instead of shrinking further")
        self.survivors = list(survivors)
        self.floor = floor


def _world_key(gen: int) -> str:
    # "g3", never a bare number: sweep_stale(rank=...) removes keys whose
    # final dot component is a rank id
    return f"elastic.world.g{gen}"


def _reform_key(gen: int, kind: str, rank: int) -> str:
    return f"elastic.reform.g{gen}.{kind}.{rank}"


def _admit_key(gen: int, rank: int) -> str:
    # the final component IS the joiner's rank, so sweep_stale(rank=...)
    # reclaims a dead joiner's request like its heartbeat; a live joiner
    # re-asserts it every poll (a replacement reusing a departed rank's
    # id races that very sweep)
    return f"elastic.admit.g{gen}.{rank}"


def _latest_sealed_gen(store: FileStore) -> int:
    """Highest sealed generation (0 = only the launch generation).
    Sealed generations are contiguous from 1, so probing upward ends at
    the live world's."""
    g = 0
    while store.get(_world_key(g + 1)) is not None:
        g += 1
    return g


class ElasticWorld:
    """One generation of the elastic world: membership, the generation's
    collectives and heartbeat watchdog, and the re-formation protocol
    that produces the next generation.

    ``store`` is the BASE run-namespaced FileStore (the re-formation
    keys live there, visible across generations); each formed
    generation's working keys ride ``store.scoped("gN")`` (generation 0
    the base namespace). ``members`` are original launcher ranks; within
    a generation ranks renumber densely (``members.index(orig_rank)``),
    so everything above sees an ordinary world of ``len(members)``.
    """

    def __init__(self, store: FileStore, orig_rank: int,
                 members: list[int], gen: int = 0,
                 heartbeat_interval_s: float | None = None,
                 lost_after_s: float | None = None,
                 stall_after_s: float | None = None,
                 reform_timeout_s: float | None = None,
                 collectives_timeout_s: float | None = None,
                 initial_world: int | None = None):
        if orig_rank not in members:
            raise ValueError(f"rank {orig_rank} not in members {members}")
        self.store = store
        self.orig_rank = int(orig_rank)
        self.members = sorted(int(m) for m in members)
        self.gen = int(gen)
        self.initial_world = (len(self.members) if initial_world is None
                              else int(initial_world))
        self.reform_timeout_s = (
            config_flags.elastic_reform_timeout_s
            if reform_timeout_s is None else float(reform_timeout_s))
        self._hb_kw = dict(interval_s=heartbeat_interval_s,
                           lost_after_s=lost_after_s,
                           stall_after_s=stall_after_s)
        self._col_timeout = collectives_timeout_s
        gen_store = store if self.gen == 0 else store.scoped(f"g{self.gen}")
        if collectives_timeout_s is not None:
            gen_store.timeout_s = float(collectives_timeout_s)
        self.rank = self.members.index(self.orig_rank)
        self.world = len(self.members)
        self.heartbeat = HeartbeatMonitor(gen_store, self.rank, self.world,
                                          rank_names=self.members,
                                          **self._hb_kw)
        self.collectives = HostCollectives(gen_store, self.rank, self.world,
                                           watchdog=self.heartbeat)
        monitor.gauge_set("resilience.world_size", self.world)
        monitor.gauge_set("resilience.degraded",
                          1.0 if self.world < self.initial_world else 0.0)

    # -- liveness ---------------------------------------------------------

    def check(self) -> None:
        """Poll the generation's watchdog (raises PeerLost/PeerStalled
        naming original launcher ranks)."""
        self.heartbeat.check()

    def close(self) -> None:
        self.heartbeat.close()

    # -- re-formation -----------------------------------------------------

    def pending_admissions(self) -> list[int]:
        """Original ranks with a live admit registration against THIS
        generation (written by a joiner's :meth:`admit`). A local scan:
        two incumbents may see different sets at one instant, so a grow
        decision is made over the union of every member's scan."""
        prefix = f"elastic.admit.g{self.gen}."
        out = set()
        for key in self.store.keys(prefix):
            tail = key[len(prefix):]
            if tail.isdigit() and int(tail) not in self.members:
                out.add(int(tail))
        return sorted(out)

    def reform(self, dead_orig_ranks: list[int],
               admit_orig_ranks: list[int] = ()) -> "ElasticWorld":
        """Form the next generation without ``dead_orig_ranks`` and with
        ``admit_orig_ranks`` (joiners waiting in :meth:`admit`); returns
        the new world (this one's watchdog is closed).

        Raises :class:`WorldFencedError` when a sealed membership
        excludes this rank and :class:`WorldTooSmallError` below
        ``flags.elastic_min_world``. A further failure inside the
        protocol (a survivor that never arrives, or arrives and never
        acks) escalates to the next generation without it; each
        generation seals at most once, so every rank that forms lands on
        the same (gen, members) and a straggler can only be fenced."""
        self.close()
        dead = set(int(r) for r in dead_orig_ranks)
        admits = sorted(set(int(r) for r in admit_orig_ranks))
        gen = self.gen
        members = self.members
        floor = max(1, int(config_flags.elastic_min_world))
        while True:
            gen += 1
            survivors = sorted(
                [r for r in members if r not in dead]
                + [a for a in admits if a not in dead and a not in members])
            if self.orig_rank not in survivors:
                raise WorldFencedError(gen, survivors, self.orig_rank)
            if len(survivors) < floor:
                raise WorldTooSmallError(survivors, floor)
            t0 = time.monotonic()
            formed, missing = self._attempt(gen, survivors)
            if formed is None:
                monitor.counter_add("resilience.reform_escalations")
                monitor.event("reform_escalated", gen=gen,
                              missing=sorted(missing),
                              rank=self.orig_rank)
                dead |= set(missing)
                continue
            seconds = time.monotonic() - t0
            joined = sorted(set(formed) - set(members))
            departed = sorted(set(members) - set(formed))
            monitor.counter_add("resilience.world_reforms")
            monitor.event("world_resize", type="lifecycle",
                          from_world=len(members), to_world=len(formed),
                          gen=gen, members=list(formed),
                          departed=departed,
                          rank=self.orig_rank, seconds=seconds)
            if joined:
                monitor.counter_add("resilience.world_grows")
                monitor.event("world_grow", type="lifecycle",
                              gen=gen, joined=joined,
                              members=list(formed),
                              from_world=len(members),
                              to_world=len(formed),
                              rank=self.orig_rank, seconds=seconds)
                # a satisfied admit request must never re-trigger a grow
                # (every member deletes; unlink races are benign)
                for key in self.store.keys("elastic.admit."):
                    tail = key.rsplit(".", 1)[-1]
                    if tail.isdigit() and int(tail) in set(joined):
                        self.store.delete(key)
            # the departed ranks' heartbeats, barrier arrivals and
            # collective values must never satisfy a later wait
            if self.store.namespace:
                for r in departed:
                    self.store.sweep_stale(rank=r)
            return ElasticWorld(
                self.store, self.orig_rank, formed, gen=gen,
                heartbeat_interval_s=self._hb_kw["interval_s"],
                lost_after_s=self._hb_kw["lost_after_s"],
                stall_after_s=self._hb_kw["stall_after_s"],
                reform_timeout_s=self.reform_timeout_s,
                collectives_timeout_s=self._col_timeout,
                initial_world=self.initial_world)

    @classmethod
    def admit(cls, store: FileStore, orig_rank: int,
              timeout_s: float = 60.0,
              heartbeat_interval_s: float | None = None,
              lost_after_s: float | None = None,
              stall_after_s: float | None = None,
              reform_timeout_s: float | None = None,
              collectives_timeout_s: float | None = None,
              initial_world: int | None = None) -> "ElasticWorld":
        """Join a live (typically degraded) world as a NEW rank — the
        elastic grow entry point, run by the replacement process.

        The joiner never seals (so it can never fence the live world). It
        registers an admit request against the latest sealed generation
        (the incumbents see it in :meth:`pending_admissions` and call
        ``reform(admit_orig_ranks=...)``), publishes its arrival under
        each successive candidate generation, and when a generation seals
        with it, acks and waits for every member's ack as
        :meth:`_attempt` does (an ack timeout rolls on to the next
        generation, which the escalating incumbents still give it). A
        generation sealed without it re-registers against that one.
        Raises TimeoutError when nothing admits it within ``timeout_s``."""
        me = int(orig_rank)
        reform_timeout = (config_flags.elastic_reform_timeout_s
                          if reform_timeout_s is None
                          else float(reform_timeout_s))
        faultpoint.hit("elastic.admit.pre_register")

        def register(g: int) -> None:
            store.set(_admit_key(g, me), json.dumps(
                {"rank": me, "host": socket.gethostname(),
                 "pid": os.getpid(), "gen": g,
                 "ts": int(time.time())}).encode())

        cur = _latest_sealed_gen(store)
        register(cur)
        monitor.counter_add("resilience.admit_requests")
        poll = store.poll_s
        deadline = time.monotonic() + float(timeout_s)
        gen = cur + 1
        t0 = time.monotonic()
        while True:
            arrive = json.dumps({"rank": me,
                                 "host": socket.gethostname(),
                                 "pid": os.getpid(),
                                 "expect": []}).encode()
            store.set(_reform_key(gen, "arrive", me), arrive)
            members = None
            while members is None:
                raw = store.get(_world_key(gen))
                if raw is not None:
                    members = [int(r) for r in json.loads(raw)["members"]]
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"admit of rank {me} timed out after {timeout_s}s "
                        f"waiting for generation {gen} to seal (no grow "
                        "attempt admitted it)")
                time.sleep(poll)
                # re-assert registration and arrival every poll: a joiner
                # carrying a dead rank's id loses them to the shrink's
                # sweep of that id whenever they land before the sweep
                register(gen - 1)
                store.set(_reform_key(gen, "arrive", me), arrive)
            if me not in members:
                register(gen)
                gen += 1
                continue
            store.set(_reform_key(gen, "ack", me), b"1")
            faultpoint.hit("elastic.admit.post_ack")
            ack_deadline = time.monotonic() + reform_timeout
            acked = False
            while True:
                missing = [r for r in members
                           if store.get(_reform_key(gen, "ack", r))
                           is None]
                if not missing:
                    acked = True
                    break
                if time.monotonic() > ack_deadline:
                    break
                time.sleep(poll)
            if not acked:
                register(gen)
                gen += 1
                continue
            world = cls(store, me, members, gen=gen,
                        heartbeat_interval_s=heartbeat_interval_s,
                        lost_after_s=lost_after_s,
                        stall_after_s=stall_after_s,
                        reform_timeout_s=reform_timeout_s,
                        collectives_timeout_s=collectives_timeout_s,
                        initial_world=initial_world)
            prev = store.get(_world_key(gen - 1))
            from_world = (len(json.loads(prev)["members"])
                          if prev is not None else None)
            monitor.counter_add("resilience.world_admits")
            monitor.event("world_grow", type="lifecycle",
                          gen=gen, joined=[me], members=list(members),
                          from_world=from_world, to_world=len(members),
                          rank=me, seconds=time.monotonic() - t0)
            return world

    def _attempt(self, gen: int, expected: list[int]
                 ) -> tuple[list[int] | None, list[int]]:
        """One generation attempt: (members, []) when generation ``gen``
        formed with this rank in it, (None, missing) when it must
        escalate. Raises WorldFencedError when the seal excludes this
        rank."""
        store = self.store
        me = self.orig_rank
        faultpoint.hit("elastic.reform.pre_arrive")
        store.set(_reform_key(gen, "arrive", me),
                  json.dumps({"rank": me, "host": socket.gethostname(),
                              "pid": os.getpid(),
                              "expect": expected}).encode())
        poll = store.poll_s
        deadline = time.monotonic() + self.reform_timeout_s
        members: list[int] | None = None
        while members is None:
            raw = store.get(_world_key(gen))
            if raw is not None:
                members = [int(r) for r in json.loads(raw)["members"]]
                break
            arrived = [r for r in expected
                       if store.get(_reform_key(gen, "arrive", r))
                       is not None]
            if (set(arrived) == set(expected)
                    or time.monotonic() > deadline):
                # seal with whoever arrived: exactly one sealer wins;
                # the others read its record on the next poll
                proposal = json.dumps(
                    {"gen": gen, "members": sorted(arrived),
                     "sealed_by": me, "ts": int(time.time())}).encode()
                if store.set_exclusive(_world_key(gen), proposal):
                    members = sorted(arrived)
                    monitor.event("reform_sealed", gen=gen,
                                  members=members, rank=me)
                    break
            time.sleep(poll)
        faultpoint.hit("elastic.reform.post_seal")
        if me not in members:
            raise WorldFencedError(gen, members, me)
        store.set(_reform_key(gen, "ack", me), b"1")
        faultpoint.hit("elastic.reform.post_ack")
        deadline = time.monotonic() + self.reform_timeout_s
        while True:
            missing = [r for r in members
                       if store.get(_reform_key(gen, "ack", r)) is None]
            if not missing:
                return members, []
            if time.monotonic() > deadline:
                # a member died between seal and ack: nobody trains under
                # this generation — escalate without it
                return None, missing
            time.sleep(poll)
